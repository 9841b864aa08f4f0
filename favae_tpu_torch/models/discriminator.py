"""GAN discriminators (port of favae_tpu/models/discriminator.py).

Parameter names follow the reference's torch state_dict
(favae_tpu/utils/torch_export.py:157-189): the conv `Discriminator` keeps
its layers in `features` (conv_in at 0, then per layer a conv and a
BatchNorm at 3i-1 and 3i) and its last conv in `head`; the
`PatchDiscriminator` keeps everything in `main`. LeakyReLU(0.2) modules sit
at the other indices and hold no parameters. Convolutions compute in the
model's compute dtype with f32 parameters; BatchNorm runs in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import DiscriminatorConfig
from favae_tpu_torch.models.blocks import Conv2d


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in f32 whatever the activation dtype: batch statistics in
    training (biased variance to normalise, unbiased into the running
    variance, momentum 0.1), running statistics in eval; output in `dtype`
    (favae_tpu/models/discriminator.py:38-82)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, self.training, self.momentum,
                         self.eps)
        return y.to(self.dtype)


class ActNorm(nn.Module):
    """Per-channel affine scale * (x + loc) (reference:
    models/discriminator.py:53-138). Its data-dependent first-batch init is
    not yet ported: loaded or default parameters are used as they are."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1))

    def forward(self, x):
        return self.scale.to(x.dtype) * (x + self.loc.to(x.dtype))


def _conv(cin, cout, stride, bias, dtype) -> Conv2d:
    return Conv2d(cin, cout, 4, stride=stride, padding=1, compute_dtype=dtype,
                  bias=bias)


def _lrelu():
    return nn.LeakyReLU(0.2)


class Discriminator(nn.Module):
    """The default discriminator (reference: models/discriminator.py:193-218):
    4x4 stride-2 convs + BatchNorm + LeakyReLU(0.2), the last stride 1."""

    def __init__(self, cfg: DiscriminatorConfig, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch, nl = cfg.base_channels, cfg.num_layers
        chs = [ch * min(2 ** i, 8) for i in range(nl + 1)]
        layers = [_conv(cfg.in_channels, ch, 2, True, dtype), _lrelu()]
        for i in range(1, nl + 1):
            layers += [_conv(chs[i - 1], chs[i], 2 if i != nl else 1, False,
                             dtype),
                       TorchBatchNorm(chs[i], dtype), _lrelu()]
        self.features = nn.Sequential(*layers)
        self.head = _conv(chs[nl], 1, 1, True, dtype)

    def forward(self, x):
        """NCHW image -> NCHW f32 logits."""
        return self.head(self.features(x.to(self.dtype))).float()


class PatchDiscriminator(nn.Module):
    """PatchGAN (reference: models/discriminator.py:141-190), BatchNorm or
    ActNorm; conv biases only with ActNorm."""

    def __init__(self, cfg: DiscriminatorConfig, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ndf, nl = cfg.base_channels, cfg.num_layers
        bias = cfg.use_actnorm

        def norm(c):
            return ActNorm(c) if cfg.use_actnorm else TorchBatchNorm(c, dtype)

        layers = [_conv(cfg.in_channels, ndf, 2, True, dtype), _lrelu()]
        prev = ndf
        for n in range(1, nl + 1):
            out = ndf * min(2 ** n, 8)
            layers += [_conv(prev, out, 2 if n < nl else 1, bias, dtype),
                       norm(out), _lrelu()]
            prev = out
        layers.append(_conv(prev, 1, 1, True, dtype))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x.to(self.dtype)).float()


def init_discriminator_(disc: nn.Module, generator: torch.Generator) -> None:
    """pix2pix init (reference: models/discriminator.py:44-50): conv weights
    N(0, 0.02), conv biases 0, BatchNorm scale N(1, 0.02), bias 0."""
    with torch.no_grad():
        for m in disc.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(1.0 + torch.randn(m.weight.shape,
                                                 generator=generator) * 0.02)
                m.bias.zero_()


def build_discriminator(cfg: DiscriminatorConfig, dtype=torch.bfloat16):
    if cfg.kind == "patch":
        return PatchDiscriminator(cfg, dtype)
    return Discriminator(cfg, dtype)
