"""Fused int8 feed-forward block of CAT decode (kernel: `csrc/ffn_int8.cu`).

Port of `favae_tpu/ops/ffn_int8.py`: the whole FeedForward block
(LN -> fc1 -> GELU -> LN -> fc2 -> residual) with both projection matrices
streamed as int8. The mid LayerNorm folds away: with
W2' = gamma_mid[:, None] * W2 and c = colsum(dequantised int8 W2'),

    fc2(LN(h)) = inv * (h @ W2' - mu * c)

where (mu, inv) are h's row statistics, so the product and the sums of h and
h^2 are gathered in one pass over F and the correction is applied once at
the end. GELU is the tanh form here (the exact bf16 engine's is erf).
Bound: the 2 * K * 4K bytes of int8 weights. The TPU kernel carries its sums
across a sequential grid; the CUDA kernels split F over the blocks into
partial products and partial sums in a scratch buffer and add them in a
fixed order (no float atomics), see `csrc/ffn_int8.cu`.

`ffn_block_int8` launches the CUDA kernels for CUDA tensors and takes the
plain PyTorch version, `ffn_block_int8_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from favae_tpu_torch import _build
from favae_tpu_torch.ops.int8_matmul import (check_cuda, chunk_of_k,
                                             quantize_weight, sm_count)

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"ffn_int8": 0}


def prepare_ffn_weights(w1: torch.Tensor, gamma_mid: torch.Tensor,
                        w2: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantise W1 and the gamma-folded W2' and compute the colsum
    correction of the dequantised W2', so that the correction matches the
    int8 weights exactly. w1 (K, F), w2 (F, K), gamma_mid (F,)."""
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(gamma_mid.float()[:, None] * w2.float())
    c = w2q.float().sum(dim=0, keepdim=True) * s2
    return dict(w1q=w1q, s1=s1, w2q=w2q, s2=s2, c=c)


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a learned scale and no bias in f32, two-pass variance,
    as the kernels compute it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float()


def folded_ffn_plain(xn: torch.Tensor, w1q, s1, w2q, s2, c,
                     eps: float) -> torch.Tensor:
    """inv * ((h @ W2') * s2 - mu * c) for h = gelu_tanh((xn @ W1) * s1):
    xn and h rounded to bf16 before their products, h's sums taken in f32
    before that rounding."""
    h = (xn.bfloat16().float() @ w1q.float()) * s1.float().reshape(1, -1)
    h = F.gelu(h, approximate="tanh")
    f = h.shape[-1]
    mu = h.sum(dim=-1, keepdim=True) / f
    var = torch.clamp((h * h).sum(dim=-1, keepdim=True) / f - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    acc = h.bfloat16().float() @ w2q.float()
    return inv * (acc * s2.float().reshape(1, -1)
                  - mu * c.float().reshape(1, -1))


def ffn_block_int8_plain(x: torch.Tensor, gamma_in: torch.Tensor,
                         prep: Dict[str, torch.Tensor],
                         eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, rounding where it rounds."""
    out = folded_ffn_plain(layer_norm_rows(x, gamma_in, eps), prep["w1q"],
                           prep["s1"], prep["w2q"], prep["s2"], prep["c"], eps)
    return (x.float() + out).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("ffn_int8")
    lib.favae_ffn_int8.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.favae_ffn_int8.restype = ctypes.c_int
    lib.favae_ffn_int8_scratch.argtypes = [ctypes.c_int] * 5
    lib.favae_ffn_int8_scratch.restype = ctypes.c_longlong
    return lib


def ffn_block_int8(x: torch.Tensor, gamma_in: torch.Tensor,
                   prep: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> torch.Tensor:
    """x (rows, K) bf16 -> LN(gamma_in) -> int8 fc1 -> GELU -> folded mid-LN
    -> int8 fc2 -> + x, (rows, K) bf16. `prep` from `prepare_ffn_weights`."""
    if x.device.type == "cpu":
        return ffn_block_int8_plain(x, gamma_in, prep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_block_int8: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"ffn_block_int8: x {tuple(x.shape)} is not (rows, K)")
    rows, k = x.shape
    f = prep["w1q"].shape[1]
    shapes = {"w1q": (k, f), "s1": (1, f), "w2q": (f, k), "s2": (1, k),
              "c": (1, k)}
    for name, shape in shapes.items():
        if tuple(prep[name].shape) != shape:
            raise ValueError(f"ffn_block_int8: {name} {tuple(prep[name].shape)}"
                             f" != {shape}")
    if gamma_in.shape != (k,) or k % 4 or f % 4:
        raise ValueError("ffn_block_int8: gamma_in must be (K,), K and F "
                         "multiples of 4")
    check_cuda("ffn_block_int8", x.device,
               [(x, torch.bfloat16), (gamma_in, torch.float32),
                (prep["w1q"], torch.int8), (prep["w2q"], torch.int8)]
               + [(prep[n], torch.float32) for n in ("s1", "s2", "c")])
    sms = sm_count(x.device)
    kc1, kc2 = chunk_of_k(k, f, sms), chunk_of_k(f, k, sms)
    lib = _library()
    scratch = torch.empty((lib.favae_ffn_int8_scratch(rows, k, f, kc1, kc2),),
                          dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.favae_ffn_int8(
            x.data_ptr(), gamma_in.data_ptr(), prep["w1q"].data_ptr(),
            prep["s1"].data_ptr(), prep["w2q"].data_ptr(),
            prep["s2"].data_ptr(), prep["c"].data_ptr(), scratch.data_ptr(),
            y.data_ptr(), rows, k, f, kc1, kc2, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ffn_block_int8: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["ffn_int8"] += 1
    return y
