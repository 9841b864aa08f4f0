"""GAN discriminators (port of favae_tpu/models/discriminator.py).

Parameter names follow the reference's torch state_dict
(favae_tpu/utils/torch_export.py:157-189): the conv `Discriminator` keeps
its layers in `features` (conv_in at 0, then per layer a conv and a
BatchNorm at 3i-1 and 3i) and its last conv in `head`; the
`PatchDiscriminator` keeps everything in `main`. LeakyReLU(0.2) modules sit
at the other indices and hold no parameters. Convolutions compute in the
model's compute dtype with f32 parameters; BatchNorm runs in f32.

Under data parallelism (`dp` on the norm modules, a `parallel.mesh.Group`)
the statistics are the global batch's, as the JAX package's global-view
step computes them over a batch sharded on its mesh
(`tests/test_train_step.py::test_train_step_sharded_over_mesh` holds its
`loss_d` to the single-device step's): BatchNorm sums over dp in the
forward and the backward, and ActNorm's first-batch init takes the global
batch's mean and standard deviation. At a dp of one the local batch is the
global one and nothing is summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import DiscriminatorConfig
from favae_tpu_torch.models.blocks import Conv2d
from favae_tpu_torch.parallel.mesh import all_reduce_sum, spans


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm of NCHW f32 `x` over the global batch of the
    group `g`: per-channel count and sum, then the sum of squared
    deviations, each summed over `g` (two passes, f32); the backward sums
    dy and dy * x_hat over `g` the same way. Updates the running
    statistics (momentum, unbiased variance) in place."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, g):
        c = x.shape[1]
        s = torch.cat([x.sum((0, 2, 3)),
                       torch.full((1,), x.numel() // c, dtype=x.dtype,
                                  device=x.device)])
        s = all_reduce_sum(s, g)
        n = s[c]
        mean = s[:c] / n
        d = x - mean[None, :, None, None]
        var = all_reduce_sum((d * d).sum((0, 2, 3)), g) / n
        invstd = torch.rsqrt(var + eps)
        x_hat = d * invstd[None, :, None, None]
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1 - momentum).add_(var * (n / (n - 1)),
                                                alpha=momentum)
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.g = g
        return x_hat * weight[None, :, None, None] + bias[None, :, None, None]

    @staticmethod
    def backward(ctx, dy):
        x_hat, weight, invstd, n = ctx.saved_tensors
        dy = dy.float()
        local = torch.stack([dy.sum((0, 2, 3)), (dy * x_hat).sum((0, 2, 3))])
        sums = all_reduce_sum(local, ctx.g)
        dx = (dy - (sums[0] / n)[None, :, None, None]
              - x_hat * (sums[1] / n)[None, :, None, None]) \
            * (weight * invstd)[None, :, None, None]
        return dx, local[1], local[0], None, None, None, None, None


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in f32 whatever the activation dtype: batch statistics in
    training (biased variance to normalise, unbiased into the running
    variance, momentum 0.1), running statistics in eval; output in `dtype`
    (favae_tpu/models/discriminator.py:38-82)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.dtype = dtype
        self.dp = None  # the dp group of a data-parallel run

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
            if spans(self.dp):
                return _GlobalBatchNorm.apply(
                    x.float(), self.weight, self.bias, self.running_mean,
                    self.running_var, self.momentum, self.eps,
                    self.dp).to(self.dtype)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, self.training, self.momentum,
                         self.eps)
        return y.to(self.dtype)


class ActNorm(nn.Module):
    """Per-channel affine scale * (x + loc) (reference:
    models/discriminator.py:53-138); `data_init` sets loc and scale from a
    first batch (`actnorm_data_init_`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1))

    def forward(self, x):
        return self.scale.to(x.dtype) * (x + self.loc.to(x.dtype))

    @staticmethod
    def batch_init_values(x: torch.Tensor, dp=None):
        """(loc, scale) (C,) f32 of an NCHW batch: -mean and
        1 / (std + 1e-6) per channel over N, H, W, std with ddof 1
        (favae_tpu/models/discriminator.py:111-117); over the global batch
        of `dp`, of which `x` is this rank's part."""
        x = x.float()
        if not spans(dp):
            return -x.mean(dim=(0, 2, 3)), 1.0 / (x.std(dim=(0, 2, 3)) + 1e-6)
        c = x.shape[1]
        s = all_reduce_sum(torch.cat([x.sum((0, 2, 3)), torch.full(
            (1,), x.numel() // c, dtype=x.dtype, device=x.device)]), dp)
        n, mean = s[c], s[:c] / s[c]
        d = x - mean[None, :, None, None]
        var = all_reduce_sum((d * d).sum((0, 2, 3)), dp) / (n - 1)
        return -mean, 1.0 / (torch.sqrt(var) + 1e-6)

    @torch.no_grad()
    def data_init(self, x: torch.Tensor, dp=None) -> torch.Tensor:
        """Set loc and scale from `x` (the global batch's statistics under
        `dp`) and return the output with them."""
        loc, scale = self.batch_init_values(x, dp)
        self.loc.copy_(loc.view_as(self.loc))
        self.scale.copy_(scale.view_as(self.scale))
        return self(x)


@torch.no_grad()
def actnorm_data_init_(disc: nn.Module, x: torch.Tensor, dp=None) -> int:
    """The reference's first-forward ActNorm init over a PatchDiscriminator
    on the NCHW batch `x`: each ActNorm takes its input's statistics, and
    its output with them feeds the layers after it, so later ActNorms see
    initialised inputs (favae_tpu/models/discriminator.py:85-117), over
    the global batch under `dp`. Returns the number of ActNorms
    initialised."""
    h, n = x.to(disc.dtype), 0
    for layer in disc.main:
        if isinstance(layer, ActNorm):
            h, n = layer.data_init(h, dp), n + 1
        else:
            h = layer(h)
    return n


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
