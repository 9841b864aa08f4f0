"""LPIPS perceptual distance with a VGG16 backbone (port of
favae_tpu/models/lpips.py).

The scaling layer, five VGG16 feature slices (relu1_2 ... relu5_3) with a
2x2 max pool between them, channel-unit-normalised feature differences, 1x1
linear heads, a spatial mean, summed over slices. `features(x)` and
`dist(fx, y)` split the two towers so the train step runs the real image's
tower once (favae_tpu/models/lpips.py:95-128).

Parameter names follow the reference's `vgg16_lpips.pt`: the convs are
`net.slice{s}.{i}` at torchvision's `vgg16.features` indices, the heads
`lin{k}.model.1.weight` (a Dropout sits at `.0`), so that file loads as it
is (`load_state_dict`). The VGG convs compute in `dtype`; the unit
normalisation and the heads run in f32. The network is frozen: its
parameters take no gradient, the input does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.models.blocks import Conv2d

# torchvision vgg16.features conv indices of each LPIPS slice, with widths;
# a max pool opens every slice after the first (at the index before)
VGG_SLICES = [((0, 64), (2, 64)), ((5, 128), (7, 128)),
              ((10, 256), (12, 256), (14, 256)),
              ((17, 512), (19, 512), (21, 512)),
              ((24, 512), (26, 512), (28, 512))]
LPIPS_CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The five slices, named as the reference's `net`."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        cin = 3
        for s, convs in enumerate(VGG_SLICES, start=1):
            layers = OrderedDict()
            if s > 1:
                layers[str(convs[0][0] - 1)] = nn.MaxPool2d(2, 2)
            for idx, cout in convs:
                layers[str(idx)] = Conv2d(cin, cout, 3, padding=1,
                                          compute_dtype=dtype)
                layers[str(idx + 1)] = nn.ReLU()
                cin = cout
            setattr(self, f"slice{s}", nn.Sequential(layers))

    def forward(self, x) -> List[torch.Tensor]:
        outs, h = [], x
        for s in range(1, 6):
            h = getattr(self, f"slice{s}")(h)
            outs.append(h)
        return outs


class _NetLin(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0),
                                   nn.Conv2d(channels, 1, 1, bias=False))


def _unit_norm(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    t = t.float()
    return t / (torch.sqrt(torch.sum(t * t, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Learned perceptual distance; images NHWC in [-1, 1], per-sample
    distances (N,) f32."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.net = VGG16Features(dtype)
        for k, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", _NetLin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)
        self.eval()

    def _tower(self, x):
        x = (x.permute(0, 3, 1, 2).float() - self.shift) / self.scale
        return self.net(x.to(self.dtype).contiguous(
            memory_format=torch.channels_last))

    def features(self, x) -> List[torch.Tensor]:
        """Unit-normalised VGG feature pyramid of one image batch (NCHW)."""
        return [_unit_norm(f) for f in self._tower(x)]

    def dist(self, fx_normed: List[torch.Tensor], y) -> torch.Tensor:
        """Distance given precomputed `features(x)` and a second image."""
        total = 0.0
        for k, fy in enumerate(self._tower(y)):
            d = (fx_normed[k] - _unit_norm(fy)) ** 2
            head = getattr(self, f"lin{k}").model[1]
            total = total + torch.mean(F.conv2d(d, head.weight.float()),
                                       dim=(1, 2, 3))
        return total

    def forward(self, x, y):
        return self.dist(self.features(x), y)
