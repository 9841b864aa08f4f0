"""Frozen copy of the port's `ops/losses.py` with its plain paths only, the
benchmark's reference (imports nothing of the port; see ../README.md).

Scalar GAN losses (port of favae_tpu/ops/losses.py), in f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """Generator hinge loss: -mean(D(fake))."""
    return -torch.mean(logits_fake.float())


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    """Discriminator hinge loss."""
    lr = torch.mean(F.relu(1.0 - logits_real.float()))
    lf = torch.mean(F.relu(1.0 + logits_fake.float()))
    return 0.5 * (lr + lf)


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    """Non-saturating BCE discriminator loss."""
    lf = torch.mean(F.softplus(logits_fake.float()))
    lr = torch.mean(F.softplus(-logits_real.float()))
    return 0.5 * (lr + lf)


def least_square_d_loss(logits_real: torch.Tensor,
                        logits_fake: torch.Tensor) -> torch.Tensor:
    """LSGAN discriminator loss."""
    lf = torch.mean((1.0 + logits_fake.float()) ** 2)
    lr = torch.mean((1.0 - logits_real.float()) ** 2)
    return 0.5 * (lr + lf)
