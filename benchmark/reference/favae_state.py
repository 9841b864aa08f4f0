"""Frozen copy of the port's `train/favae_state.py` cut to what the
benchmark's configurations run, the benchmark's reference (imports nothing
of the port; see ../README.md).

FA-VAE train state: the model (generator, discriminator and the codebook
EMA in its buffers), the frozen LPIPS, two Adam optimizers and the step.
Adam(0.5, 0.9) over encoder, decoder and quantizer, with the model-level
pairwise-DSL sigmas in a group of their own at `sigma_lr` (non-pairwise
sigmas live in the encoder and decoder and take the main lr), and a second
Adam over the discriminator (favae_scripts/train_favae.py:292-305), both
`torch.optim.Adam` with eps 1e-8, the same update as `optax.adam`. First
moments in another dtype than float32 are not carried: a configuration that
asks for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from benchmark.reference.config import TrainConfig
from benchmark.reference.lpips import LPIPS
from benchmark.reference.vqgan import VQGANFCM


def split_params(model: VQGANFCM) -> Tuple[List[torch.nn.Parameter],
                                           List[torch.nn.Parameter],
                                           List[torch.nn.Parameter]]:
    """(generator main, generator pairwise sigmas, discriminator)."""
    main, sigma, disc = [], [], []
    for name, p in model.named_parameters():
        if name.startswith("discriminator."):
            disc.append(p)
        elif name == "sigmas":
            sigma.append(p)
        else:
            main.append(p)
    return main, sigma, disc


def make_optimizers(model: VQGANFCM, train_cfg: TrainConfig, lr: float
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    if train_cfg.adam_mu_dtype != "float32":
        raise NotImplementedError(
            "the benchmark's reference carries float32 Adam moments only, "
            f"not {train_cfg.adam_mu_dtype}")
    main, sigma, disc = split_params(model)
    groups_g = [(main, lr)] + ([(sigma, train_cfg.sigma_lr)] if sigma else [])
    betas = (train_cfg.adam_b1, train_cfg.adam_b2)
    opt_g = torch.optim.Adam([{"params": p, "lr": g_lr}
                              for p, g_lr in groups_g],
                             lr=lr, betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(disc, lr=lr, betas=betas, eps=1e-8)
    return opt_g, opt_d


@dataclasses.dataclass
class FavaeTrainState:
    model: VQGANFCM
    lpips: LPIPS
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0
