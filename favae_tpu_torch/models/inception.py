"""FID InceptionV3 (pool3 features), Fréchet distance and rFID (port of
favae_tpu/models/inception.py; reference: losses/inception.py:22-334, the
pytorch-fid wrapper).

The graph is torchvision's InceptionV3 up to the final average pool, with
pytorch-fid's module names (`Conv2d_1a_3x3`, `Mixed_5b.branch1x1.conv` /
`.bn`, ...), so pytorch-fid's `pt_inception-2015-12-05` file loads strictly
once its `fc.*` entries are dropped (`load_inception`). The FID quirks are
the JAX package's:

* input NHWC in [-1, 1], resized to 299 x 299 bilinearly as
  `jax.image.resize` does it: half-pixel centres, and an antialiasing
  filter when downscaling (a no-op when upscaling);
* convolutions without bias in the compute dtype, BatchNorm (eps 1e-3)
  and everything after it in f32;
* "SAME" padding for the unstrided convolutions (1 x 7 and 7 x 1 too);
* the in-block average pools with `count_include_pad=False`;
* `Mixed_7b` with the average-pool branch, `Mixed_7c` with the max-pool;
* the global mean as the (N, 2048) f32 output.

No Pallas kernel lies behind Inception: the convolutions are PyTorch's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FID_DIM = 2048
FID_SIZE = 299


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3, running statistics, f32) ->
    ReLU; `same` pads by half the kernel, else no padding."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 stride: int = 1, same: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kh, kw = kernel
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=(kh // 2, kw // 2) if same else 0,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)
        self.dtype = dtype

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                     stride=self.conv.stride, padding=self.conv.padding)
        bn = self.bn
        y = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=bn.eps)
        return F.relu(y)


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, (1, 1), dtype=dtype)
        self.branch5x5_1 = ConvBN(cin, 48, (1, 1), dtype=dtype)
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), dtype=dtype)
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), dtype=dtype)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), dtype=dtype)
        self.branch_pool = ConvBN(cin, pool_features, (1, 1), dtype=dtype)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), 2, False, dtype)
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), dtype=dtype)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), 2, False, dtype)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, (1, 1), dtype=dtype)
        self.branch7x7_1 = ConvBN(cin, c7, (1, 1), dtype=dtype)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), dtype=dtype)
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), dtype=dtype)
        self.branch7x7dbl_1 = ConvBN(cin, c7, (1, 1), dtype=dtype)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), dtype=dtype)
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), dtype=dtype)
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), dtype=dtype)
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), dtype=dtype)
        self.branch_pool = ConvBN(cin, 192, (1, 1), dtype=dtype)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, (1, 1), dtype=dtype)
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), 2, False, dtype)
        self.branch7x7x3_1 = ConvBN(cin, 192, (1, 1), dtype=dtype)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), dtype=dtype)
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), dtype=dtype)
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), 2, False, dtype)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """`pool` "avg" (Mixed_7b) or "max" (Mixed_7c, pytorch-fid's
    FIDInceptionE_2)."""

    def __init__(self, cin: int, pool: str, dtype):
        super().__init__()
        self.pool = pool
        self.branch1x1 = ConvBN(cin, 320, (1, 1), dtype=dtype)
        self.branch3x3_1 = ConvBN(cin, 384, (1, 1), dtype=dtype)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), dtype=dtype)
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), dtype=dtype)
        self.branch3x3dbl_1 = ConvBN(cin, 448, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), dtype=dtype)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), dtype=dtype)
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), dtype=dtype)
        self.branch_pool = ConvBN(cin, 192, (1, 1), dtype=dtype)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool_same(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_to_fid(x: torch.Tensor) -> torch.Tensor:
    """NCHW f32 images to 299 x 299 as `jax.image.resize(..., "bilinear")`:
    half-pixel centres, antialiased when downscaling."""
    if x.shape[-2:] == (FID_SIZE, FID_SIZE):
        return x
    down = x.shape[-2] > FID_SIZE or x.shape[-1] > FID_SIZE
    return F.interpolate(x, size=(FID_SIZE, FID_SIZE), mode="bilinear",
                         align_corners=False, antialias=down)


class InceptionV3FID(nn.Module):
    """pool3 (2048-d) features of NHWC images in [-1, 1], any size (resized
    to 299 unless `resize_input` is False), as (N, 2048) f32."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        d = dtype
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), 2, False, d)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3), 1, False, d)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), dtype=d)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1), 1, False, d)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3), 1, False, d)
        self.Mixed_5b = InceptionA(192, 32, d)
        self.Mixed_5c = InceptionA(256, 64, d)
        self.Mixed_5d = InceptionA(288, 64, d)
        self.Mixed_6a = InceptionB(288, d)
        self.Mixed_6b = InceptionC(768, 128, d)
        self.Mixed_6c = InceptionC(768, 160, d)
        self.Mixed_6d = InceptionC(768, 160, d)
        self.Mixed_6e = InceptionC(768, 192, d)
        self.Mixed_7a = InceptionD(768, d)
        self.Mixed_7b = InceptionE(1280, "avg", d)
        self.Mixed_7c = InceptionE(2048, "max", d)

    @torch.inference_mode()
    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_to_fid(x)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


def load_inception(model: InceptionV3FID, path_or_sd) -> None:
    """Load pytorch-fid's InceptionV3 state_dict (`pt_inception-2015-12-05`,
    a path or the dict) strictly, its `fc.*` classifier dropped (the
    counterpart of favae_tpu/utils/torch_convert.py::convert_inception)."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("fc.")}, strict=True)


def _sqrtm(a):
    """scipy's matrix square root without its console report (SciPy 1.16
    and later take no `disp` and never print)."""
    import inspect

    import scipy.linalg
    if "disp" in inspect.signature(scipy.linalg.sqrtm).parameters:
        return scipy.linalg.sqrtm(a, disp=False)[0]
    return scipy.linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians, numpy (host side; needs sqrtm)."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(feats_a, feats_b) -> float:
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    return frechet_distance(a.mean(0), np.cov(a, rowvar=False),
                            b.mean(0), np.cov(b, rowvar=False))
