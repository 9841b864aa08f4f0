"""GroupNorm with an optional fused SiLU, forward and backward (kernels:
Triton here, and `csrc/gn_bwd_sums.cu`).

Port of `favae_tpu/ops/gn_pallas.py`. An activation is an NCHW tensor in
`torch.channels_last` memory format, whose bytes are the (N, H*W, C) view the
TPU kernels stream. The forward is two passes over it:

1. `gn_stats` (Triton): per-(n, c) sums of x and x^2 in f32 (TPU:
   `_col_stats`, gn_pallas.py:137).
2. `gn_affine` folds the (N, 2, C) sums into per-channel a, b (a few KB of
   plain PyTorch, as `_affine_from_stats`, gn_pallas.py:152, is plain XLA),
   then `gn_apply` (Triton) writes y = act(x * a + b) (TPU: `_apply_kernel`
   inside `_gn_act_fwd`, gn_pallas.py:178).

The backward (TPU: `_gn_act_bwd`, gn_pallas.py:197) is two more:

3. `gn_bwd_sums` (CUDA C++, one launch): per-(n, c) sums of g and g * xhat
   in f32, with g = dy through the SiLU gradient (recomputed from x * a + b)
   and xhat = x * inv - mean * inv (TPU: `_bwd_sums_kernel`,
   gn_pallas.py:89), folded in the same launch into the per-channel c2, c3
   and the per-image sums that dscale and dbias add up (the XLA fold of
   gn_pallas.py:219-228; `gn_bwd_fold` here in plain PyTorch). Its blocks
   stream x and dy by TMA bulk copies; the last block of an image to finish
   adds the image's partials and folds them.
4. `gn_bwd_dx` (Triton) writes dx = a * g + c2 + c3 * x in x.dtype (TPU:
   `_bwd_dx_kernel`, gn_pallas.py:109; its c1 is a).

The forward statistics (1) have each program reduce a chunk of rows across
whole contiguous C rows, so loads are coalesced, and write f32 partial sums
to an (N, chunks, 2, C) buffer that PyTorch sums; the backward sums (3) add
theirs in the last block of an image, in block order. No float atomics, so
the sums are the same from run to run. The TPU kernels carry their sums
across a sequential grid axis instead, which has no counterpart among
blocks that run in no order. All four passes stream without a matrix
product, so they are bound by bytes: forward two reads of x and one write
of y, backward two reads of x and dy and one write of dx. At the largest
expe5 shape, 16 x 128 x 256^2 bf16, that is 805 MB forward (about 240 us at
3.35 TB/s) and 1.34 GB backward (about 400 us).

Semantics are flax GroupNorm's: variance E[x^2] - E[x]^2 in f32, clipped at
0, eps inside the rsqrt. SiLU runs in f32 before the cast to `out_dtype`, as
the TPU kernel does; the JAX package's default XLA path applies it after the
cast, which differs by at most one ulp of `out_dtype` (none in f32).

`group_norm_act` is a `torch.autograd.Function`: for CUDA tensors its
forward launches `gn_stats` and `gn_apply` and its backward `gn_bwd_sums`
(and one PyTorch sum over images) and `gn_bwd_dx`; CPU tensors take the
plain versions of all four. `group_norm_act_plain` is the same Function
with the plain versions on any device. `triton` is imported and the CUDA
library built at the first launch, so this module imports without either.
"""

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from favae_tpu_torch import _build
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, launch_on, sm_count,
                                             stream_counters)

# kernel launches since the last reset; chip_smoke.py zeroes and reads them
LAUNCHES = {"gn_stats": 0, "gn_apply": 0, "gn_bwd_sums": 0, "gn_bwd_dx": 0}
# incoming gradients that were not channels_last and had to be copied
DY_COPIES = {"not_channels_last": 0}

# triton.language, bound by _jit() at the first launch; the kernel bodies
# below resolve `tl` through this module's globals when Triton compiles them
tl = None
_JIT = {}

_BLOCK_ELEMS = 4096  # elements of x one program holds per step


def _stats_kernel(x_ptr, part_ptr, HW, C, rows_per_prog, n_chunks,
                  BLOCK_R: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    # program (n, chunk): rows [chunk * rows_per_prog, + rows_per_prog) of
    # image n (rows_per_prog is a multiple of BLOCK_R); writes its sums of x
    # and x^2 to part[n, chunk, 0, :] and part[n, chunk, 1, :]
    n = tl.program_id(0)
    chunk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + n.to(tl.int64) * HW * C
    acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    r0 = chunk * rows_per_prog
    for r in range(r0, r0 + rows_per_prog, BLOCK_R):
        rows = r + tl.arange(0, BLOCK_R)
        mask = (rows < HW)[:, None] & cmask[None, :]
        xv = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask,
                     other=0.0).to(tl.float32)
        acc1 += xv
        acc2 += xv * xv
    out = part_ptr + (n * n_chunks + chunk) * 2 * C + cols
    tl.store(out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(out + C, tl.sum(acc2, axis=0), mask=cmask)


def _apply_kernel(x_ptr, a_ptr, b_ptr, y_ptr, HW, C, SILU: "tl.constexpr",
                  BLOCK_R: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    # program (n, rb): rows [rb * BLOCK_R, + BLOCK_R) of image n
    n = tl.program_id(0)
    rows = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < HW)[:, None] & cmask[None, :]
    a = tl.load(a_ptr + n * C + cols, mask=cmask, other=0.0)
    b = tl.load(b_ptr + n * C + cols, mask=cmask, other=0.0)
    off = n.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
    xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    y = xv * a[None, :] + b[None, :]
    if SILU:
        y = y * tl.sigmoid(y)
    tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


def _bwd_dx_kernel(x_ptr, dy_ptr, a_ptr, b_ptr, c2_ptr, c3_ptr, dx_ptr, HW, C,
                   SILU: "tl.constexpr", BLOCK_R: "tl.constexpr",
                   BLOCK_C: "tl.constexpr"):
    # program (n, rb) as in _apply_kernel: dx = a * g + c2 + c3 * x
    n = tl.program_id(0)
    rows = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < HW)[:, None] & cmask[None, :]
    vec = n * C + cols
    a = tl.load(a_ptr + vec, mask=cmask, other=0.0)[None, :]
    c2 = tl.load(c2_ptr + vec, mask=cmask, other=0.0)[None, :]
    c3 = tl.load(c3_ptr + vec, mask=cmask, other=0.0)[None, :]
    off = n.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
    xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(dy_ptr + off, mask=mask, other=0.0).to(tl.float32)
    if SILU:
        b = tl.load(b_ptr + vec, mask=cmask, other=0.0)[None, :]
        ypre = xv * a + b
        s = tl.sigmoid(ypre)
        g = g * s * (1.0 + ypre * (1.0 - s))
    dx = a * g + c2 + c3 * xv
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)


def _jit():
    global tl
    if not _JIT:
        import triton
        import triton.language

        tl = triton.language
        for name, fn in (("stats", _stats_kernel), ("apply", _apply_kernel),
                         ("bwd_dx", _bwd_dx_kernel)):
            _JIT[name] = triton.jit(fn)
    return _JIT


def _blocks(c: int) -> Tuple[int, int]:
    block_c = 1 << (c - 1).bit_length()
    return max(1, _BLOCK_ELEMS // block_c), block_c


def _check_activation(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be a 4-D channels_last tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    n, c, h, w = x.shape
    if h * w * c >= 1 << 31:
        raise ValueError(f"{name}: one image of {h * w * c} elements "
                         "overflows the kernel's 32-bit row offsets")


def _check_vectors(name: str, x: torch.Tensor, *vecs: torch.Tensor) -> None:
    n, c = x.shape[:2]
    for t in vecs:
        if t.shape != (n, c) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: per-channel vectors must be contiguous "
                             f"float32 ({n}, {c}) tensors on {x.device}")


def _check_grad(name: str, x: torch.Tensor, dy: torch.Tensor) -> None:
    _check_activation(dy, name)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} on {dy.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f16/f32 inputs; f64 stays f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def _reduction_grid(x: torch.Tensor, block_r: int) -> Tuple[int, int]:
    """(rows a program reduces, chunks an image): about four programs an SM
    over the whole batch."""
    n, _, h, w = x.shape
    hw = h * w
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_image = max(1, -(-4 * sms // n))
    rows = block_r * -(-(-(-hw // block_r)) // per_image)
    return rows, -(-hw // rows)


# ---------------------------------------------------------------------------
# pass 1: statistics
# ---------------------------------------------------------------------------

def gn_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Per-(n, c) sums over H, W in f32: (N, 2, C), [:, 0] of x, [:, 1] of
    x^2."""
    xf = x.to(_compute_dtype(x))
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1)


def gn_stats(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_stats_plain(x)
    _check_activation(x, "gn_stats")
    n, c, h, w = x.shape
    block_r, block_c = _blocks(c)
    rows, chunks = _reduction_grid(x, block_r)
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    jit = _jit()
    with torch.cuda.device(x.device):
        jit["stats"][(n, chunks)](x, part, h * w, c, rows, chunks,
                                  BLOCK_R=block_r, BLOCK_C=block_c,
                                  num_warps=4)
    LAUNCHES["gn_stats"] += 1
    return part.sum(dim=1)


# ---------------------------------------------------------------------------
# fold (plain PyTorch on both devices)
# ---------------------------------------------------------------------------

def gn_affine(sums: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              num_groups: int, hw: int, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """(N, 2, C) sums -> per-channel (N, C) a, b with GroupNorm(x) = x*a + b,
    and the per-group (N, G, 1) mean and inverse std the backward needs
    (favae_tpu/ops/gn_pallas.py:152-168), in the sums' dtype. Few ops: on
    the card each is a launch the host pays for."""
    n, _, c = sums.shape
    cg = c // num_groups
    moments = sums.view(n, 2, num_groups, cg).sum(-1, keepdim=True) / (hw * cg)
    mean, ex2 = moments.unbind(1)
    inv = (ex2 - mean * mean).clamp_min_(0.0).add_(eps).rsqrt_()
    a = inv * scale.to(sums.dtype).view(num_groups, cg)
    b = torch.addcmul(bias.to(sums.dtype).view(num_groups, cg), mean, a,
                      value=-1.0)
    return a.view(n, c), b.view(n, c), mean, inv


# ---------------------------------------------------------------------------
# pass 2: normalise + affine + activation
# ---------------------------------------------------------------------------

def gn_apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    """y = act(x * a + b) in f32, cast to out_dtype; channels_last."""
    y = x.to(a.dtype) * _col(a) + _col(b)
    if act == "silu":
        y = F.silu(y)
    return y.to(out_dtype, memory_format=torch.channels_last)


def gn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_apply_plain(x, a, b, act, out_dtype)
    _check_activation(x, "gn_apply")
    _check_vectors("gn_apply", x, a, b)
    n, c, h, w = x.shape
    block_r, block_c = _blocks(c)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device,
                    memory_format=torch.channels_last)
    jit = _jit()
    with torch.cuda.device(x.device):
        jit["apply"][(n, -(-h * w // block_r))](
            x, a, b, y, h * w, c, SILU=act == "silu", BLOCK_R=block_r,
            BLOCK_C=block_c, num_warps=4)
    LAUNCHES["gn_apply"] += 1
    return y


# ---------------------------------------------------------------------------
# pass 3: backward sums
# ---------------------------------------------------------------------------

def act_grad_plain(x, dy, a, b, act):
    """(x in the compute dtype, g = dy through the activation's gradient)."""
    xf = x.to(a.dtype)
    g = dy.to(a.dtype)
    if act == "silu":
        ypre = xf * _col(a) + _col(b)
        s = torch.sigmoid(ypre)
        g = g * s * (1.0 + ypre * (1.0 - s))
    return xf, g


def gn_bwd_sums_plain(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                      act: Optional[str]) -> torch.Tensor:
    """Per-(n, c) sums over H, W: (N, 2, C), [:, 0] of g, [:, 1] of
    g * (x * p + q)."""
    xf, g = act_grad_plain(x, dy, a, b, act)
    xhat = xf * _col(p) + _col(q)
    return torch.stack([g.sum(dim=(2, 3)), (g * xhat).sum(dim=(2, 3))], dim=1)


def gn_bwd_fold(sums: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, hw: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(N, 2, C) backward sums -> (dscale (C,), dbias (C,), c2 (N, C),
    c3 (N, C)) with dx = a * g + c2 + c3 * x
    (favae_tpu/ops/gn_pallas.py:219-228)."""
    n, _, c = sums.shape
    num_groups = mean.shape[1]
    cg = c // num_groups
    m = hw * cg
    gs, gx = sums.unbind(1)
    dbias, dscale = gs.sum(0), gx.sum(0)
    sg = scale.to(sums.dtype)
    m1 = (sg * gs).view(n, num_groups, cg).sum(-1, keepdim=True)
    m2 = (sg * gx).view(n, num_groups, cg).sum(-1, keepdim=True)
    c3 = -(inv * inv) * m2 / m
    c2 = -(inv * m1) / m - c3 * mean
    return (dscale, dbias, c2.expand(n, num_groups, cg).reshape(n, c),
            c3.expand(n, num_groups, cg).reshape(n, c))


class BwdSums(NamedTuple):
    """What the backward's first pass gives the second: dscale and dbias
    (C,), the per-channel c2, c3 (N, C) of dx = a * g + c2 + c3 * x, and
    the per-image sums (N, 2, C) that dscale and dbias add up ([:, 0] of g,
    [:, 1] of g * xhat)."""
    dscale: torch.Tensor
    dbias: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor
    sums: torch.Tensor


def gn_bwd_sums_fold_plain(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, scale: torch.Tensor,
                           mean: torch.Tensor, inv: torch.Tensor,
                           act: Optional[str]) -> BwdSums:
    """`gn_bwd_sums` in plain PyTorch: `gn_bwd_sums_plain` at xhat =
    x * inv - mean * inv, then `gn_bwd_fold`. mean and inv are the
    forward's (N, G, 1)."""
    n, c = a.shape
    cg = c // mean.shape[1]
    p = inv.expand(-1, -1, cg).reshape(n, c)
    q = (-mean * inv).expand(-1, -1, cg).reshape(n, c)
    sums = gn_bwd_sums_plain(x, dy, a, b, p, q, act)
    return BwdSums(*gn_bwd_fold(sums, scale, mean, inv, x.shape[2] * x.shape[3]),
                   sums)


# csrc/gn_bwd_sums.cu: consumer threads, ring slots, blocks an image at most
# and the dynamic shared memory it allows (favae_gn_bwd_sums_layout gives
# the built library's own, which chip_smoke.py compares)
BWD_CONSUMERS = 256
BWD_STAGES = 4
BWD_MAX_BLOCKS = 16
BWD_SMEM_MAX = 160 * 1024
# plan targets: bytes of x and dy a ring slot (smaller where a block streams
# long: measured on an H100, 8 KB slots were faster from 256 KB a block on,
# 16 KB below), blocks an SM over the grid, bytes of x and dy a block at
# least (fewer, larger blocks on small images, where the last block's sum of
# the partials is the kernel's tail)
BWD_STAGE_BYTES = 16 * 1024
BWD_LONG_STAGE_BYTES = 8 * 1024
BWD_LONG_BLOCK_BYTES = 256 * 1024
BWD_BLOCKS_PER_SM = 2
BWD_MIN_BLOCK_BYTES = 64 * 1024
MAX_IMAGES = 4096  # images a stream's arrival counters cover
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


class BwdSumsPlan(NamedTuple):
    """Block `blk` of image n takes rows [blk * rows_per_block, +
    rows_per_block) of its HW; its ring slots hold `stage_rows` rows of x
    and of dy; the fold's constants lie at byte `fold_at` of its `smem`
    bytes of dynamic shared memory (after the ring, which the end of the
    block reuses)."""
    blocks: int
    rows_per_block: int
    stage_rows: int
    fold_at: int
    smem: int


def bwd_align_rows(c: int) -> int:
    """Rows whose bytes are a multiple of 16 in any of the three dtypes,
    from a 16-byte aligned row on: 8 / gcd(C, 8)."""
    return 8 // math.gcd(c, 8)


@functools.lru_cache(maxsize=None)
def bwd_sums_plan(n: int, hw: int, c: int, x_size: int, dy_size: int,
                  sms: int = DEFAULT_SMS) -> BwdSumsPlan:
    """The kernel's work plan for x, dy (N, HW, C) of itemsizes x_size,
    dy_size: blocks an image up to BWD_BLOCKS_PER_SM an SM over the grid, at
    most BWD_MAX_BLOCKS and each with BWD_MIN_BLOCK_BYTES of x and dy; slots
    of BWD_STAGE_BYTES (BWD_LONG_STAGE_BYTES for a block of
    BWD_LONG_BLOCK_BYTES or more), whole groups of `bwd_align_rows` rows."""
    align = bwd_align_rows(c)
    row = c * (x_size + dy_size)
    want = min(BWD_MAX_BLOCKS, -(-BWD_BLOCKS_PER_SM * sms // n),
               max(1, hw * row // BWD_MIN_BLOCK_BYTES))
    per = -(-hw // want)
    stage_bytes = (BWD_LONG_STAGE_BYTES if per * row >= BWD_LONG_BLOCK_BYTES
                   else BWD_STAGE_BYTES)
    stage = max(align, min(stage_bytes // row, -(-per // align) * align)
                // align * align)
    unit = 8 if c % 8 == 0 else 1
    fold_at = max(BWD_STAGES * stage * row, 2 * BWD_CONSUMERS * unit * 4,
                  2 * c * 4)
    return BwdSumsPlan(-(-hw // per), per, stage, fold_at,
                       fold_at + 3 * c * 4)


def block_pieces(plan: BwdSumsPlan, n: int, blk: int, hw: int, c: int
                 ) -> List[Tuple[str, int, int]]:
    """What block `blk` of image n reads, as the kernel cuts it: ("head",
    row, rows) and ("tail", ...) by ordinary loads, ("bulk", row, rows) for
    each ring slot's bulk copies; rows of the image."""
    align = bwd_align_rows(c)
    r0 = blk * plan.rows_per_block
    r1 = min(hw, r0 + plan.rows_per_block)
    hb = min(r1, r0 + (-(n * hw + r0)) % align)
    te = hb + (r1 - hb) // align * align
    pieces = [("head", r0, hb - r0)] if hb > r0 else []
    pieces += [("bulk", r, min(plan.stage_rows, te - r))
               for r in range(hb, te, plan.stage_rows)]
    if te < r1:
        pieces.append(("tail", te, r1 - te))
    return pieces


@functools.lru_cache(maxsize=None)
def _bwd_kernel(device: torch.device):
    """The launch function, with the kernel's shared-memory allowance set
    on `device`: once a device, not a call."""
    lib = _build.library("gn_bwd_sums")
    with torch.cuda.device(device):
        err = lib.favae_gn_bwd_sums_init()
    if err != 0:
        raise RuntimeError(f"gn_bwd_sums: cudaFuncSetAttribute failed with "
                           f"CUDA error {err}")
    fn = lib.favae_gn_bwd_sums
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bwd_kernel_layout() -> Tuple[int, ...]:
    """The built library's (threads, consumers, stages, max blocks, shared
    memory allowance)."""
    out = (ctypes.c_int * 5)()
    _build.library("gn_bwd_sums").favae_gn_bwd_sums_layout(out)
    return tuple(out)


_ARRIVED: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def gn_bwd_sums(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, act: Optional[str]) -> BwdSums:
    """The backward's first pass and its fold: one launch of
    csrc/gn_bwd_sums.cu on CUDA, then one sum over images for dscale and
    dbias. x (any of bf16, f16, f32) and dy (likewise) channels_last and
    16-byte aligned; a, b (N, C), scale (C,), mean and inv (N, G, 1) f32."""
    if x.device.type == "cpu":
        return gn_bwd_sums_fold_plain(x, dy, a, b, scale, mean, inv, act)
    _check_activation(x, "gn_bwd_sums")
    _check_grad("gn_bwd_sums", x, dy)
    _check_vectors("gn_bwd_sums", x, a, b)
    n, c, h, w = x.shape
    scale = scale.float()
    groups = mean.shape[1] if mean.dim() >= 2 else 0
    for t in (mean, inv):
        if t.shape[:2] != (n, groups) or t.numel() != n * groups \
                or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("gn_bwd_sums: mean and inv must be float32 "
                             f"(N, G[, 1]) tensors on {x.device}")
    if groups == 0 or c % groups or scale.shape != (c,) \
            or not scale.is_contiguous() or scale.device != x.device:
        raise ValueError(f"gn_bwd_sums: {c} channels, {groups} groups, "
                         f"scale {tuple(scale.shape)}")
    if c > (8 if c % 8 == 0 else 1) * BWD_CONSUMERS:
        raise ValueError(f"gn_bwd_sums: C = {c} is more than the kernel's "
                         f"{8 * BWD_CONSUMERS} (C % 8 == 0) or "
                         f"{BWD_CONSUMERS} (otherwise) channels")
    if n > MAX_IMAGES:
        raise ValueError(f"gn_bwd_sums: N = {n} is more than {MAX_IMAGES}")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("gn_bwd_sums: x and dy must be 16-byte aligned")
    hw = h * w
    plan = bwd_sums_plan(n, hw, c, x.element_size(), dy.element_size(),
                         sm_count(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((n, plan.blocks, 2, c), **f32)
    sums = torch.empty((n, 2, c), **f32)
    c2, c3 = torch.empty((n, c), **f32), torch.empty((n, c), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    arrived = stream_counters(_ARRIVED, "gn_bwd_sums", x.device, stream,
                              torch.cuda.is_current_stream_capturing(),
                              MAX_IMAGES)
    err = launch_on(
        x.device, _bwd_kernel(x.device), x.data_ptr(), dy.data_ptr(),
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), part.data_ptr(), sums.data_ptr(), c2.data_ptr(),
        c3.data_ptr(), arrived.data_ptr(), n, hw, c, groups, mean.stride(0),
        mean.stride(1), inv.stride(0), inv.stride(1), *plan,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[dy.dtype], int(act == "silu"),
        stream)
    if err != 0:
        raise RuntimeError(f"gn_bwd_sums: CUDA launch failed with error {err}")
    LAUNCHES["gn_bwd_sums"] += 1
    dbias, dscale = sums.sum(0)
    return BwdSums(dscale, dbias, c2, c3, sums)


# ---------------------------------------------------------------------------
# pass 4: dx
# ---------------------------------------------------------------------------

def gn_bwd_dx_plain(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
                    act: Optional[str]) -> torch.Tensor:
    """dx = a * g + c2 + c3 * x in f32, cast to x.dtype; channels_last."""
    xf, g = act_grad_plain(x, dy, a, b, act)
    dx = _col(a) * g + _col(c2) + _col(c3) * xf
    return dx.to(x.dtype, memory_format=torch.channels_last)


def gn_bwd_dx(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
              act: Optional[str]) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_bwd_dx_plain(x, dy, a, b, c2, c3, act)
    _check_activation(x, "gn_bwd_dx")
    _check_grad("gn_bwd_dx", x, dy)
    _check_vectors("gn_bwd_dx", x, a, b, c2, c3)
    n, c, h, w = x.shape
    block_r, block_c = _blocks(c)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    jit = _jit()
    with torch.cuda.device(x.device):
        jit["bwd_dx"][(n, -(-h * w // block_r))](
            x, dy, a, b, c2, c3, dx, h * w, c, SILU=act == "silu",
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8)
    LAUNCHES["gn_bwd_dx"] += 1
    return dx


# ---------------------------------------------------------------------------
# GroupNorm(+SiLU) with its gradient
# ---------------------------------------------------------------------------

class _GroupNormAct(torch.autograd.Function):
    """Residuals as `_gn_act_fwd` keeps them (gn_pallas.py:194): x, scale,
    the per-channel a, b and the per-group mean and inverse std."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, out_dtype, plain):
        stats, apply = ((gn_stats_plain, gn_apply_plain) if plain
                        else (gn_stats, gn_apply))
        a, b, mean, inv = gn_affine(stats(x), scale, bias, num_groups,
                                    x.shape[2] * x.shape[3], eps)
        ctx.save_for_backward(x, scale, a, b, mean, inv)
        ctx.act, ctx.plain = act, plain
        return apply(x, a, b, act, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, a, b, mean, inv = ctx.saved_tensors
        need_x, need_scale, need_bias = ctx.needs_input_grad[:3]
        sums_fn, dx_fn = ((gn_bwd_sums_fold_plain, gn_bwd_dx_plain)
                          if ctx.plain else (gn_bwd_sums, gn_bwd_dx))
        if not dy.is_contiguous(memory_format=torch.channels_last):
            dy = dy.contiguous(memory_format=torch.channels_last)
            DY_COPIES["not_channels_last"] += 1
        dscale, dbias, c2, c3, _ = sums_fn(x, dy, a, b, scale, mean, inv,
                                           ctx.act)
        dx = dx_fn(x, dy, a, b, c2, c3, ctx.act) if need_x else None
        return (dx, dscale.to(scale.dtype) if need_scale else None,
                dbias.to(scale.dtype) if need_bias else None,
                None, None, None, None, None)


def _check_args(x, scale, num_groups, act):
    if act not in (None, "silu"):
        raise ValueError(f"group_norm_act: unknown act {act!r}")
    c = x.shape[1]
    if c % num_groups or scale.shape != (c,):
        raise ValueError(f"group_norm_act: {c} channels, {num_groups} groups, "
                         f"scale shape {tuple(scale.shape)}")


def group_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int, eps: float = 1e-5,
                         act: Optional[str] = None,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`group_norm_act` through the plain versions of all four passes, on
    any device; differentiable through the plain backward."""
    _check_args(x, scale, num_groups, act)
    return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act,
                               out_dtype or x.dtype, True)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5, act: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm of an NCHW x (channels_last on CUDA) with f32 statistics,
    then the affine and an optional SiLU ("silu"); output in `out_dtype`
    (default x.dtype), channels_last. Differentiable in x, scale and bias:
    the backward launches the two backward kernels on CUDA."""
    _check_args(x, scale, num_groups, act)
    return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act,
                               out_dtype or x.dtype, False)
