"""Differentiable Gaussian blur as two depthwise convolutions.

Port of `favae_tpu/ops/gaussian.py`: the taps are built from a (learnable)
sigma, the input is reflect-padded, and the blur runs as a horizontal then a
vertical 1-D depthwise `F.conv2d(groups=C)` in the input's dtype, with the
taps computed in f32. Gradients flow into sigma, which is what makes the
Dynamic Spectrum Loss "dynamic".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel_size: int, sigma: torch.Tensor) -> torch.Tensor:
    """Normalised 1-D Gaussian taps (favae_tpu/ops/gaussian.py:17-24):
    x = linspace(-(k-1)/2, (k-1)/2, k), pdf = exp(-0.5 (x / sigma)^2),
    divided by its sum; f32."""
    half = (kernel_size - 1) * 0.5
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32,
                       device=sigma.device)
    pdf = torch.exp(-0.5 * torch.square(x / sigma))
    return pdf / torch.sum(pdf)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of a reflect pad by `pad` of an axis of n: the periodic
    reflection numpy and jnp.pad give when pad >= n (period 2(n - 1))."""
    idx = torch.arange(-pad, n + pad, device=device).abs()
    if n == 1:
        return torch.zeros_like(idx)
    idx = idx % (2 * (n - 1))
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W of an NCHW tensor by `pad`; `F.pad` where it
    applies (pad < H, W), else the same periodic reflection as jnp.pad, so
    small feature maps blur as in the JAX package."""
    h, w = x.shape[2:]
    if pad < min(h, w):
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = x.index_select(2, _reflect_index(h, pad, x.device))
    return x.index_select(3, _reflect_index(w, pad, x.device))


def gaussian_blur(x: torch.Tensor, kernel_size: int,
                  sigma: torch.Tensor) -> torch.Tensor:
    """Depthwise Gaussian blur of an NCHW tensor with reflect padding, in
    x.dtype."""
    if kernel_size <= 1:
        return x
    c = x.shape[1]
    xp = reflect_pad(x, kernel_size // 2)
    k1 = gaussian_kernel_1d(kernel_size, sigma).to(x.dtype)
    kh = k1.view(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size)
    kv = k1.view(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1)
    y = F.conv2d(xp, kh, groups=c)
    return F.conv2d(y, kv, groups=c)


def gaussian_blur_nhwc(x: torch.Tensor, kernel_size: int,
                       sigma: torch.Tensor) -> torch.Tensor:
    """`gaussian_blur` on an NHWC tensor, as the JAX package's
    `gaussian_blur_nhwc` (favae_tpu/ops/gaussian.py:33-65)."""
    return gaussian_blur(x.permute(0, 3, 1, 2), kernel_size,
                         sigma).permute(0, 2, 3, 1)
