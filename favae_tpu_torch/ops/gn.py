"""GroupNorm with an optional fused SiLU, forward (kernels: Triton, here).

Port of the forward of `favae_tpu/ops/gn_pallas.py`. An activation is an NCHW
tensor in `torch.channels_last` memory format, whose bytes are the
(N, H*W, C) view the TPU kernels stream. Two passes over it:

1. `gn_stats`: per-(n, c) sums of x and x^2 in f32 (TPU: `_col_stats`,
   gn_pallas.py:137). Each program reduces a chunk of rows across whole
   contiguous C rows, so loads are coalesced, and writes f32 partial sums to
   an (N, chunks, 2, C) buffer; the chunks are summed in PyTorch. The TPU
   kernel carries its sums across a sequential grid axis instead, which has
   no counterpart among blocks that run in no order.
2. `gn_affine` folds the (N, 2, C) sums into per-channel a, b (a few KB of
   plain PyTorch, as `_affine_from_stats`, gn_pallas.py:152, is plain XLA),
   then `gn_apply` writes y = act(x * a + b) (TPU: `_apply_kernel` inside
   `_gn_act_fwd`, gn_pallas.py:178).

Semantics are flax GroupNorm's: variance E[x^2] - E[x]^2 in f32, clipped at
0, eps inside the rsqrt. SiLU runs in f32 before the cast to `out_dtype`, as
the TPU kernel does; the JAX package's default XLA path applies it after the
cast, which differs by at most one ulp of `out_dtype` (none in f32).

Bound: two reads of x and one write of y. At the largest expe5 shape,
16 x 256^2 x 128 bf16, that is 805 MB, about 240 us at 3.35 TB/s.

`gn_stats`, `gn_apply` and `group_norm_act` launch the Triton kernels for
CUDA tensors and take the plain versions only for CPU tensors. `triton` is
imported at the first launch, so this module imports without it.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# kernel launches since the last reset; chip_smoke.py zeroes and reads them
LAUNCHES = {"gn_stats": 0, "gn_apply": 0}

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


def _jit():
    global tl
    if not _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT["stats"] = triton.jit(_stats_kernel)
        _JIT["apply"] = triton.jit(_apply_kernel)
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


# ---------------------------------------------------------------------------
# pass 1: statistics
# ---------------------------------------------------------------------------

def gn_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Per-(n, c) sums over H, W in f32: (N, 2, C), [:, 0] of x, [:, 1] of
    x^2."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1)


def gn_stats(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_stats_plain(x)
    _check_activation(x, "gn_stats")
    n, c, h, w = x.shape
    hw = h * w
    block_r, block_c = _blocks(c)
    # about four programs an SM over the whole batch
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_image = max(1, -(-4 * sms // n))
    rows = block_r * -(-(-(-hw // block_r)) // per_image)
    chunks = -(-hw // rows)
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    jit = _jit()
    with torch.cuda.device(x.device):
        jit["stats"][(n, chunks)](x, part, hw, c, rows, chunks,
                                  BLOCK_R=block_r, BLOCK_C=block_c,
                                  num_warps=4)
    LAUNCHES["gn_stats"] += 1
    return part.sum(dim=1)


# ---------------------------------------------------------------------------
# fold (plain PyTorch on both devices)
# ---------------------------------------------------------------------------

def gn_affine(sums: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              num_groups: int, hw: int,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2, C) sums -> per-channel (N, C) f32 a, b with GroupNorm(x) =
    x*a + b (favae_tpu/ops/gn_pallas.py:152-168). Few ops: on the card each
    is a launch the host pays for."""
    n, _, c = sums.shape
    cg = c // num_groups
    moments = sums.view(n, 2, num_groups, cg).sum(-1, keepdim=True) / (hw * cg)
    mean, ex2 = moments.unbind(1)
    inv = (ex2 - mean * mean).clamp_min_(0.0).add_(eps).rsqrt_()
    a = inv * scale.float().view(num_groups, cg)
    b = torch.addcmul(bias.float().view(num_groups, cg), mean, a, value=-1.0)
    return a.view(n, c), b.view(n, c)


# ---------------------------------------------------------------------------
# pass 2: normalise + affine + activation
# ---------------------------------------------------------------------------

def gn_apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    """y = act(x * a + b) in f32, cast to out_dtype; channels_last."""
    y = x.float() * a[:, :, None, None] + b[:, :, None, None]
    if act == "silu":
        y = F.silu(y)
    return y.to(out_dtype, memory_format=torch.channels_last)


def gn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_apply_plain(x, a, b, act, out_dtype)
    _check_activation(x, "gn_apply")
    n, c, h, w = x.shape
    for t in (a, b):
        if t.shape != (n, c) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError("gn_apply: a and b must be contiguous float32 "
                             f"({n}, {c}) tensors on {x.device}")
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
# GroupNorm(+SiLU)
# ---------------------------------------------------------------------------

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
    """The plain PyTorch version of `group_norm_act`, on any device."""
    _check_args(x, scale, num_groups, act)
    a, b = gn_affine(gn_stats_plain(x), scale, bias, num_groups,
                     x.shape[2] * x.shape[3], eps)
    return gn_apply_plain(x, a, b, act, out_dtype or x.dtype)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5, act: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm of an NCHW x (channels_last on CUDA) with f32 statistics,
    then the affine and an optional SiLU ("silu"); output in `out_dtype`
    (default x.dtype), channels_last."""
    _check_args(x, scale, num_groups, act)
    a, b = gn_affine(gn_stats(x), scale, bias, num_groups,
                     x.shape[2] * x.shape[3], eps)
    return gn_apply(x, a, b, act, out_dtype or x.dtype)
