"""The LayerNorm chains of the exact token step, one launch a sublayer
boundary (kernel: Triton, `_add_layer_norm_kernel`).

`GPT.sample`'s token step runs each layer's six LayerNorms on the 8 rows of
a CFG batch, each wrapped in casts, and each sublayer ends in a residual
add. Op by op that is seven launches a boundary, each moving a few tens of
KB: launch latency, not bytes. The JAX package's `jit` fuses the chain; here
one launch computes it, in the order and with the roundings of the plain op
sequence (`add_ln_plain`, `gelu_ln_plain`):

- `add_ln(h, x, gamma_out, gamma_next, out_dtype)`, the boundary after a
  sublayer: `y = LN(h) * gamma_out` rounded to x's dtype (without
  `gamma_out`, y = h), `x' = y + x` rounded to x's dtype, and
  `x_n = LN(x') * gamma_next` in `out_dtype`; returns `(x', x_n)`. Without
  `x` (the embedding into `init_norm`), `x' = y` rounded to `out_dtype`.
- `gelu_ln(h, gamma, out_dtype)`, the feed-forward's middle:
  `LN(gelu_erf(h)) * gamma`, the GELU rounded to h's dtype first, as
  `nn.GELU` on h rounds it.

LN is f32 with a biased variance and eps 1e-5, no beta. One program a row
holds the whole row in registers: one load of each input, the mean and then
the centred variance from the registers (two passes, as
`ffn_int8.layer_norm_rows`), one store of each output. The width is a
compile-time constant, so each width and form is its own specialisation,
compiled at its first launch (the eager first token of `graphs.run_steps`,
before the capture).

CUDA tensors take the kernel; CPU tensors take the plain op sequence, which
is what the token step ran before the kernel, bit for bit. The kernel
agrees with it within a rounding of the stored dtype (its f32 sums run in
another order). The wrapper raises on what it does not take (a tensor that
records gradients, rows that are not contiguous, a device other than the
CPU or CUDA): it never falls back. `triton` is imported at the first launch,
so this module imports without it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5

# kernel launches since the last reset (graphs.launch_counts)
LAUNCHES = {"add_ln": 0}

# triton.language and its CUDA extras, bound by _jit() at the first launch;
# the kernel body resolves `tl` and `gdc` through this module's globals
# when Triton compiles it
tl = gdc = None
_JIT = {}


def _add_layer_norm_kernel(h_ptr, x_ptr, g_out_ptr, g_next_ptr, y_ptr,
                           out_ptr, D, eps, GELU: "tl.constexpr",
                           NORM_H: "tl.constexpr", RESIDUAL: "tl.constexpr",
                           BLOCK: "tl.constexpr"):
    # launched as a programmatic dependent: the next kernel may start now
    # (a `rows_gemm` product streams its weights meanwhile); nothing is
    # read before the kernel before this one has completed
    gdc.gdc_launch_dependents()
    gdc.gdc_wait()
    # program r: row r of every tensor, D columns held in BLOCK registers;
    # GELU is gelu_ln's form, which stores no y, the others add_ln's
    row = tl.program_id(0).to(tl.int64) * D
    cols = tl.arange(0, BLOCK)
    m = cols < D
    v = tl.load(h_ptr + row + cols, mask=m, other=0.0).to(tl.float32)
    if GELU:
        v = 0.5 * v * (1.0 + tl.math.erf(v * 0.7071067811865476))
        v = v.to(h_ptr.dtype.element_ty).to(tl.float32)
    else:
        if NORM_H:
            mean = tl.sum(v, axis=0) / D
            d = tl.where(m, v - mean, 0.0)
            var = tl.sum(d * d, axis=0) / D
            g = tl.load(g_out_ptr + cols, mask=m, other=0.0)
            v = d * tl.math.rsqrt(var + eps) * g
        if RESIDUAL:
            x = tl.load(x_ptr + row + cols, mask=m, other=0.0)
            v = v.to(x_ptr.dtype.element_ty).to(tl.float32) + x.to(tl.float32)
        v = v.to(y_ptr.dtype.element_ty)
        tl.store(y_ptr + row + cols, v, mask=m)
        v = v.to(tl.float32)
    mean = tl.sum(v, axis=0) / D
    d = tl.where(m, v - mean, 0.0)
    var = tl.sum(d * d, axis=0) / D
    g = tl.load(g_next_ptr + cols, mask=m, other=0.0)
    out = d * tl.math.rsqrt(var + eps) * g
    tl.store(out_ptr + row + cols, out.to(out_ptr.dtype.element_ty), mask=m)


def _jit():
    global tl, gdc
    if not _JIT:
        import triton
        import triton.language
        import triton.language.extra.cuda

        tl, gdc = triton.language, triton.language.extra.cuda
        _JIT["add_ln"] = triton.jit(_add_layer_norm_kernel)
    return _JIT


def _ln(v: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """`FixedBetaLayerNorm`: f32 out."""
    return F.layer_norm(v.float(), gamma.shape, gamma, None, EPS)


def add_ln_plain(h: torch.Tensor, x: Optional[torch.Tensor],
                 gamma_out: Optional[torch.Tensor], gamma_next: torch.Tensor,
                 out_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`add_ln`'s op sequence in PyTorch (see the module docstring)."""
    y = h if gamma_out is None else _ln(h, gamma_out)
    if x is None:
        y = y.to(out_dtype)
    else:
        y = y.to(x.dtype) + x
    return y, _ln(y, gamma_next).to(out_dtype)


def gelu_ln_plain(h: torch.Tensor, gamma: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """`gelu_ln`'s op sequence in PyTorch."""
    return _ln(F.gelu(h), gamma).to(out_dtype)


def _check(h: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    ts = [t for t in (h,) + others if t is not None]
    if h.device.type != "cuda":
        raise ValueError(f"add_ln: unsupported device {h.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("add_ln: tensors that record gradients (the kernel "
                         "has no backward; call it under inference_mode)")
    for t in ts:
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"add_ln: every tensor must be contiguous on "
                             f"{h.device}, got {tuple(t.shape)} on {t.device} "
                             f"strides {t.stride()}")
        if t.dtype not in (torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"add_ln: unsupported dtype {t.dtype}")
    d = h.shape[-1]
    for t in others:
        if t is not None and t.shape[-1] != d:
            raise ValueError(f"add_ln: width {t.shape[-1]} against h's {d}")


def _launch(h, x, g_out, g_next, y, out, *, gelu: bool) -> None:
    # a pointer the form leaves out is passed as h or g_next, never touched
    d = h.shape[-1]
    block = 1 << (d - 1).bit_length()
    jit = _jit()
    with torch.cuda.device(h.device):
        jit["add_ln"][(h.numel() // d,)](
            h, h if x is None else x, g_next if g_out is None else g_out,
            g_next, h if y is None else y, out, d, EPS, GELU=gelu,
            NORM_H=g_out is not None, RESIDUAL=x is not None, BLOCK=block,
            num_warps=4 if block <= 2048 else 8, launch_pdl=True)
    LAUNCHES["add_ln"] += 1


def add_ln(h: torch.Tensor, x: Optional[torch.Tensor],
           gamma_out: Optional[torch.Tensor], gamma_next: torch.Tensor,
           out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x', x_n) of a sublayer boundary (module docstring): one launch for
    CUDA tensors, the plain op sequence for CPU tensors."""
    if h.device.type == "cpu":
        return add_ln_plain(h, x, gamma_out, gamma_next, out_dtype)
    _check(h, x, gamma_out, gamma_next)
    if x is not None and x.shape != h.shape:
        raise ValueError(f"add_ln: x {tuple(x.shape)} against h "
                         f"{tuple(h.shape)}")
    y = torch.empty(h.shape, dtype=out_dtype if x is None else x.dtype,
                    device=h.device)
    out = torch.empty(h.shape, dtype=out_dtype, device=h.device)
    _launch(h, x, gamma_out, gamma_next, y, out, gelu=False)
    return y, out


def gelu_ln(h: torch.Tensor, gamma: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """LN(gelu(h)) * gamma in `out_dtype` (module docstring): one launch for
    CUDA tensors, the plain op sequence for CPU tensors."""
    if h.device.type == "cpu":
        return gelu_ln_plain(h, gamma, out_dtype)
    _check(h, gamma)
    out = torch.empty(h.shape, dtype=out_dtype, device=h.device)
    _launch(h, None, None, gamma, None, out, gelu=True)
    return out
