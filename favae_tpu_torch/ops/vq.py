"""Nearest codebook entry per token (kernel: `csrc/vq_nearest.cu`).

Port of `favae_tpu/ops/vq_pallas.py`: idx[n] = argmax_k (x[n] . e[k] +
bias[k]) without materialising the (N, K) score matrix on the card. Ties go
to the lowest index, as `torch.argmax` and the TPU kernel do.

`vq_nearest` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version, `vq_nearest_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from favae_tpu_torch import _build

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"vq_nearest": 0}

_BN, _BK = 64, 128  # token and code tile of csrc/vq_nearest.cu


def vq_nearest_plain(x: torch.Tensor, e: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax_k (x @ e.T + bias) in f32, materialising the scores; int32."""
    scores = x.float() @ e.float().T
    if bias is not None:
        scores = scores + bias.float()
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _kernel():
    fn = _build.library("vq_nearest").favae_vq_nearest
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _splits(n: int, k: int, device: torch.device):
    """Split the codebook across blocks until the token tiles fill the SMs
    about twice over: returns (tiles_per_split, splits)."""
    n_tiles = -(-n // _BN)
    k_tiles = -(-k // _BK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(k_tiles, max(1, -(-2 * sms // n_tiles)))
    per = -(-k_tiles // want)
    return per, -(-k_tiles // per)


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
    per, splits = _splits(n, k, x.device)
    part_score = torch.empty((splits, n), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), e.data_ptr(),
                        None if bias is None else bias.data_ptr(),
                        part_score.data_ptr(), part_idx.data_ptr(),
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
