"""2-D DFT of a real NHWC tensor as two stacked matrix products.

Port of `favae_tpu/ops/dft.py` (plain tensor code, not a kernel): for real
x, fft2(x) = D_H x D_W with D_N[k, m] = exp(-2 pi i k m / N). Each stage is
one matmul with the cosine and sine matrices stacked on the output axis:

    stage W:  z = [C_W; S_W] x   ->  z[:, :, :w] = x C^T, z[:, :, w:] = x S^T
    stage H:  t = [C_H; S_H] z   ->  F_re = C z_re - S z_im,
                                     F_im = S z_re + C z_im

Both matmuls take their inputs in `compute_dtype` and accumulate in f32 (as
PyTorch's bf16 matmuls do on either device); each stage's result is stored
in `compute_dtype`, as the JAX package's `preferred_element_type=f32` then
`astype(cdt)` does. `torch.fft.fft2` is the tests' oracle.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dft_mats_np(n: int, norm: str) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    c, s = np.cos(ang), np.sin(ang)
    if norm == "ortho":
        c, s = c / np.sqrt(n), s / np.sqrt(n)
    return np.asarray(c, np.float32), np.asarray(s, np.float32)


@functools.lru_cache(maxsize=32)
def _stacked(n: int, norm: str, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """[C; S] as one (2n, n) tensor in `dtype` on `device` (cached: on the
    card each fresh constant would be a host-to-device copy)."""
    c, s = _dft_mats_np(n, norm)
    return torch.from_numpy(np.concatenate([c, s], axis=0)).to(device, dtype)


def dft2_real_nhwc(x: torch.Tensor, norm: str = "ortho",
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D DFT over (H, W) of a real NHWC tensor -> (real, imag), each NHWC
    in `compute_dtype` (default f32); torch.fft.fft2(x, dim=(1, 2),
    norm=norm) up to that dtype."""
    cdt = compute_dtype or torch.float32
    n, h, w, c = x.shape
    x = x.to(cdt).contiguous()
    dws = _stacked(w, norm, cdt, x.device)                 # (2w, w)
    z = torch.matmul(dws, x.view(n * h, w, c))             # (nh, 2w, c)
    dhs = _stacked(h, norm, cdt, x.device)                 # (2h, h)
    t = torch.matmul(dhs, z.view(n, h, 2 * w * c)).view(n, 2 * h, 2 * w, c)
    f_re = t[:, :h, :w] - t[:, h:, w:]
    f_im = t[:, h:, :w] + t[:, :h, w:]
    return f_re, f_im
