"""GroupNorm with an optional fused SiLU, forward and backward (kernels:
Triton, here).

Port of `favae_tpu/ops/gn_pallas.py`. An activation is an NCHW tensor in
`torch.channels_last` memory format, whose bytes are the (N, H*W, C) view the
TPU kernels stream. The forward is two passes over it:

1. `gn_stats`: per-(n, c) sums of x and x^2 in f32 (TPU: `_col_stats`,
   gn_pallas.py:137).
2. `gn_affine` folds the (N, 2, C) sums into per-channel a, b (a few KB of
   plain PyTorch, as `_affine_from_stats`, gn_pallas.py:152, is plain XLA),
   then `gn_apply` writes y = act(x * a + b) (TPU: `_apply_kernel` inside
   `_gn_act_fwd`, gn_pallas.py:178).

The backward (TPU: `_gn_act_bwd`, gn_pallas.py:197) is two more:

3. `gn_bwd_sums`: per-(n, c) sums of g and g * xhat in f32, with g = dy
   through the SiLU gradient (recomputed from x * a + b) and
   xhat = x * inv - mean * inv (TPU: `_bwd_sums_kernel`, gn_pallas.py:89).
4. `gn_bwd_fold` turns them into dscale, dbias and the per-channel c2, c3
   (plain PyTorch, gn_pallas.py:219-228), then `gn_bwd_dx` writes
   dx = a * g + c2 + c3 * x in x.dtype (TPU: `_bwd_dx_kernel`,
   gn_pallas.py:109; its c1 is a).

The reductions (1, 3) have each program reduce a chunk of rows across whole
contiguous C rows, so loads are coalesced, and write f32 partial sums to an
(N, chunks, 2, C) buffer that PyTorch sums: no atomics, so the sums are the
same from run to run. The TPU kernels carry their sums across a sequential
grid axis instead, which has no counterpart among blocks that run in no
order. All four passes stream without a matrix product, so they are bound by
bytes: forward two reads of x and one write of y, backward two reads of x and
dy and one write of dx. At the largest expe5 shape, 16 x 128 x 256^2 bf16,
that is 805 MB forward (about 240 us at 3.35 TB/s) and 1.34 GB backward
(about 400 us).

Semantics are flax GroupNorm's: variance E[x^2] - E[x]^2 in f32, clipped at
0, eps inside the rsqrt. SiLU runs in f32 before the cast to `out_dtype`, as
the TPU kernel does; the JAX package's default XLA path applies it after the
cast, which differs by at most one ulp of `out_dtype` (none in f32).

`group_norm_act` is a `torch.autograd.Function`: for CUDA tensors its
forward launches `gn_stats` and `gn_apply` and its backward `gn_bwd_sums`
and `gn_bwd_dx`; CPU tensors take the plain versions of all four.
`group_norm_act_plain` is the same Function with the plain versions on any
device. `triton` is imported at the first launch, so this module imports
without it.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def _bwd_sums_kernel(x_ptr, dy_ptr, a_ptr, b_ptr, p_ptr, q_ptr, part_ptr, HW,
                     C, rows_per_prog, n_chunks, SILU: "tl.constexpr",
                     BLOCK_R: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    # program (n, chunk) as in _stats_kernel; g = dy (through the SiLU
    # gradient at x * a + b), xhat = x * p + q; writes its sums of g and
    # g * xhat to part[n, chunk, 0, :] and part[n, chunk, 1, :]
    n = tl.program_id(0)
    chunk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    vec = n * C + cols
    a = tl.load(a_ptr + vec, mask=cmask, other=0.0)[None, :]
    b = tl.load(b_ptr + vec, mask=cmask, other=0.0)[None, :]
    p = tl.load(p_ptr + vec, mask=cmask, other=0.0)[None, :]
    q = tl.load(q_ptr + vec, mask=cmask, other=0.0)[None, :]
    base = n.to(tl.int64) * HW * C
    acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    r0 = chunk * rows_per_prog
    for r in range(r0, r0 + rows_per_prog, BLOCK_R):
        rows = r + tl.arange(0, BLOCK_R)
        mask = (rows < HW)[:, None] & cmask[None, :]
        off = base + rows[:, None] * C + cols[None, :]
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(dy_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if SILU:
            ypre = xv * a + b
            s = tl.sigmoid(ypre)
            g = g * s * (1.0 + ypre * (1.0 - s))
        acc1 += g
        acc2 += g * (xv * p + q)
    out = part_ptr + (n * n_chunks + chunk) * 2 * C + cols
    tl.store(out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(out + C, tl.sum(acc2, axis=0), mask=cmask)


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
                         ("bwd_sums", _bwd_sums_kernel),
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


def gn_bwd_sums(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                act: Optional[str]) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_bwd_sums_plain(x, dy, a, b, p, q, act)
    _check_activation(x, "gn_bwd_sums")
    _check_grad("gn_bwd_sums", x, dy)
    _check_vectors("gn_bwd_sums", x, a, b, p, q)
    n, c, h, w = x.shape
    block_r, block_c = _blocks(c)
    rows, chunks = _reduction_grid(x, block_r)
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    jit = _jit()
    with torch.cuda.device(x.device):
        jit["bwd_sums"][(n, chunks)](
            x, dy, a, b, p, q, part, h * w, c, rows, chunks,
            SILU=act == "silu", BLOCK_R=block_r, BLOCK_C=block_c,
            num_warps=8)
    LAUNCHES["gn_bwd_sums"] += 1
    return part.sum(dim=1)


# ---------------------------------------------------------------------------
# backward fold (plain PyTorch on both devices)
# ---------------------------------------------------------------------------

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
        sums_fn, dx_fn = ((gn_bwd_sums_plain, gn_bwd_dx_plain) if ctx.plain
                          else (gn_bwd_sums, gn_bwd_dx))
        if not dy.is_contiguous(memory_format=torch.channels_last):
            dy = dy.contiguous(memory_format=torch.channels_last)
            DY_COPIES["not_channels_last"] += 1
        n, c = a.shape
        cg = c // mean.shape[1]
        p = inv.expand(-1, -1, cg).reshape(n, c)
        q = (-mean * inv).expand(-1, -1, cg).reshape(n, c)
        sums = sums_fn(x, dy, a, b, p, q, ctx.act)
        dscale, dbias, c2, c3 = gn_bwd_fold(sums, scale, mean, inv,
                                            x.shape[2] * x.shape[3])
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
