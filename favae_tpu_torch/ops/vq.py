"""Nearest codebook entry per token (kernel: `csrc/vq_nearest.cu`).

Port of `favae_tpu/ops/vq_pallas.py`: idx[n] = argmax_k (x[n] . e[k] +
bias[k]) without materialising the (N, K) score matrix on the card. Ties go
to the lowest index, as `torch.argmax` and the TPU kernel do.

`vq_nearest` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version, `vq_nearest_plain`, only for CPU tensors. The kernel takes
its products on the tensor cores in error-compensated TF32 (three TF32
products for one of f32); `vq_nearest_tf32x3_plain` is that arithmetic in
plain PyTorch, for the tests: its indices equal the f32 argmax outside
near-ties.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from favae_tpu_torch import _build
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, launch_on, sm_count,
                                             stream_counters)

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"vq_nearest": 0}

_BN, _BK = 128, 128  # token and code tile of csrc/vq_nearest.cu
MAX_TILES = 1 << 16  # token tiles a stream's arrival counters cover


def vq_nearest_plain(x: torch.Tensor, e: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax_k (x @ e.T + bias) in f32, materialising the scores; int32."""
    scores = x.float() @ e.float().T
    if bias is not None:
        scores = scores + bias.float()
    return torch.argmax(scores, dim=-1).to(torch.int32)


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 bits of mantissa) to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` does."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def cut_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32: the low 13 bits of the mantissa dropped, as the
    tensor cores read an f32 operand."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def vq_nearest_tf32x3_plain(x: torch.Tensor, e: torch.Tensor,
                            bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The kernel's error-compensated product in plain PyTorch: x = hi + lo
    and e = hi + lo, hi rounded to TF32 and the remainder cut to TF32,
    scores = x_lo e_hi + x_hi e_lo + x_hi e_hi summed in f32 (the lo x lo
    term, 2^-22 of the product, is dropped); int32."""
    x, e = x.float(), e.float()
    x_hi, e_hi = round_tf32(x), round_tf32(e)
    x_lo, e_lo = cut_tf32(x - x_hi), cut_tf32(e - e_hi)
    scores = (x_lo @ e_hi.T + x_hi @ e_lo.T) + x_hi @ e_hi.T
    if bias is not None:
        scores = scores + bias.float()
    return torch.argmax(scores, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _kernel(device: torch.device):
    """The launch function, with the kernel's shared-memory allowance set
    on `device`: once a device, not a call."""
    lib = _build.library("vq_nearest")
    with torch.cuda.device(device):
        err = lib.favae_vq_nearest_init()
    if err != 0:
        raise RuntimeError(f"vq_nearest: cudaFuncSetAttribute failed with "
                           f"CUDA error {err}")
    fn = lib.favae_vq_nearest
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class VqPlan(NamedTuple):
    """Blocks of `_BN` tokens; the code tiles of `_BK` cut into `splits`
    runs of `tiles_per_split`, one block each (one run: no scratch)."""
    tiles_per_split: int
    splits: int


@functools.lru_cache(maxsize=None)
def vq_plan(n: int, k: int, sms: int = DEFAULT_SMS) -> VqPlan:
    """The codebook is split across blocks while they stay within one for
    each SM (a block fills one): N 4096, K 1024 gives 32 token tiles x 4
    splits = 128 blocks."""
    n_tiles = -(-n // _BN)
    k_tiles = -(-k // _BK)
    want = min(k_tiles, max(1, sms // n_tiles))
    per = -(-k_tiles // want)
    return VqPlan(per, -(-k_tiles // per))


_ARRIVED: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _arrived(device: torch.device, stream: int,
             capturing: bool) -> torch.Tensor:
    """The arrival counters of launches on one stream of `device`, one for
    each token tile (`int8_matmul.stream_counters`)."""
    return stream_counters(_ARRIVED, "vq_nearest", device, stream, capturing,
                           MAX_TILES)


def vq_nearest(x: torch.Tensor, e: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, D) f32, e (K, D) f32, bias (K,) f32 or None -> (N,) int32."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, e, bias)
    if x.device.type != "cuda":
        raise ValueError(f"vq_nearest: unsupported device {x.device}")
    if x.dim() != 2 or e.dim() != 2 or x.shape[1] != e.shape[1]:
        raise ValueError(f"vq_nearest: shapes {tuple(x.shape)} and "
                         f"{tuple(e.shape)} are not (N, D) and (K, D)")
    tensors = [x, e] + ([] if bias is None else [bias])
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("vq_nearest: inputs must be contiguous float32 "
                             f"tensors on {x.device}")
    n, d = x.shape
    k = e.shape[0]
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"vq_nearest: bias shape {tuple(bias.shape)} != ({k},)")
    if k == 0:
        raise ValueError("vq_nearest: empty codebook")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    per, splits = vq_plan(n, k, sm_count(x.device))
    if -(-n // _BN) > MAX_TILES:
        raise ValueError(f"vq_nearest: N = {n} is more than "
                         f"{MAX_TILES * _BN} tokens")
    part_score = part_idx = None
    if splits > 1:
        part_score = torch.empty((splits, n), dtype=torch.float32,
                                 device=x.device)
        part_idx = torch.empty((splits, n), dtype=torch.int32,
                               device=x.device)
    err = launch_on(
        x.device, _kernel(x.device), x.data_ptr(), e.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if part_score is None else part_score.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(),
        _arrived(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                 torch.cuda.is_current_stream_capturing()).data_ptr(),
        out.data_ptr(), n, k, d, per, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_nearest: CUDA launch failed with error {err}")
    LAUNCHES["vq_nearest"] += 1
    return out


def vq_nearest_cosine(flatten: torch.Tensor,
                      embed_normed: torch.Tensor) -> torch.Tensor:
    """Cosine metric: the caller l2-normalises both sides
    (favae_tpu/ops/vq_pallas.py:104-108)."""
    return vq_nearest(flatten, embed_normed)


def vq_nearest_euclidean(flatten: torch.Tensor,
                         embed: torch.Tensor) -> torch.Tensor:
    """Euclidean metric through the rank-equal 2 x.e - ||e||^2
    (favae_tpu/ops/vq_pallas.py:111-115)."""
    e2 = torch.sum(embed * embed, dim=-1)
    return vq_nearest(2.0 * flatten, embed, -e2)
