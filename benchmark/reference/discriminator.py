"""Frozen copy of the port's `models/discriminator.py` cut to what the
benchmark's configurations run, the benchmark's reference (imports nothing
of the port; see ../README.md): the conv discriminator with BatchNorm. The
PatchGAN, ActNorm and data parallelism are not carried: a configuration
that asks for one raises.

Parameter names follow the reference's torch state_dict
(favae_tpu/utils/torch_export.py:157-189): the conv `Discriminator` keeps
its layers in `features` (conv_in at 0, then per layer a conv and a
BatchNorm at 3i-1 and 3i) and its last conv in `head`. LeakyReLU(0.2)
modules sit at the other indices and hold no parameters. Convolutions
compute in the model's compute dtype with f32 parameters; BatchNorm runs in
f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import DiscriminatorConfig
from benchmark.reference.blocks import Conv2d


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


def build_discriminator(cfg: DiscriminatorConfig, dtype=torch.bfloat16):
    if cfg.kind != "conv" or cfg.use_actnorm:
        raise NotImplementedError(
            "the benchmark's reference carries the conv discriminator with "
            f"BatchNorm only, not kind={cfg.kind!r} "
            f"use_actnorm={cfg.use_actnorm}")
    return Discriminator(cfg, dtype)
