"""FA-VAE train state: the model (generator, discriminator and the codebook
EMA in its buffers), the frozen LPIPS, two Adam optimizers and the step.

Port of `favae_tpu/train/favae_state.py` (reference optimizer setup:
favae_scripts/train_favae.py:292-305): Adam(0.5, 0.9) over encoder, decoder
and quantizer, with the model-level pairwise-DSL sigmas in a group of their
own at `sigma_lr` (non-pairwise sigmas live in the encoder and decoder and
take the main lr, as in the reference), and a second Adam over the
discriminator. `torch.optim.Adam` with eps 1e-8 is the same update as
`optax.adam`. The JAX package's state is one functional pytree; here the
parameters, buffers and optimizer moments are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from favae_tpu_torch.config import LossConfig, TrainConfig, VQGANConfig
from favae_tpu_torch.models.lpips import LPIPS
from favae_tpu_torch.models.vqgan import VQGANFCM, build_model


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
            f"adam_mu_dtype={train_cfg.adam_mu_dtype} is not yet ported to "
            "favae_tpu_torch")
    main, sigma, disc = split_params(model)
    betas = (train_cfg.adam_b1, train_cfg.adam_b2)
    groups: List[Dict] = [{"params": main}]
    if sigma:
        groups.append({"params": sigma, "lr": train_cfg.sigma_lr})
    opt_g = torch.optim.Adam(groups, lr=lr, betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(disc, lr=lr, betas=betas, eps=1e-8)
    return opt_g, opt_d


@dataclasses.dataclass
class FavaeTrainState:
    model: VQGANFCM
    lpips: LPIPS
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0

    @classmethod
    def create(cls, model_cfg: VQGANConfig, loss_cfg: LossConfig,
               train_cfg: TrainConfig, lr: float, device=None,
               lpips_state_dict: Optional[Dict[str, torch.Tensor]] = None,
               model: Optional[VQGANFCM] = None) -> "FavaeTrainState":
        """Seeded random weights (`train_cfg.seed`) on `device` (CUDA unless
        named), or `model` as given; LPIPS from `lpips_state_dict` (the
        reference's `vgg16_lpips.pt` layout) or random. LPIPS computes in the
        model's compute dtype."""
        if model is None:
            model = build_model(model_cfg, device, seed=train_cfg.seed,
                                gaussian_kernel=loss_cfg.gaussian_kernel,
                                dsl_init_sigma=loss_cfg.dsl_init_sigma)
        dev = next(model.parameters()).device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed + 2)
            lpips = LPIPS(getattr(torch, model_cfg.compute_dtype))
        if lpips_state_dict is not None:
            lpips.load_state_dict(lpips_state_dict, strict=True)
        lpips.to(dev)
        opt_g, opt_d = make_optimizers(model, train_cfg, lr)
        return cls(model=model, lpips=lpips, opt_g=opt_g, opt_d=opt_d)
