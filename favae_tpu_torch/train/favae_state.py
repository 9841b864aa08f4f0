"""FA-VAE train state: the model (generator, discriminator and the codebook
EMA in its buffers), the frozen LPIPS, two Adam optimizers and the step.

Port of `favae_tpu/train/favae_state.py` (reference optimizer setup:
favae_scripts/train_favae.py:292-305): Adam(0.5, 0.9) over encoder, decoder
and quantizer, with the model-level pairwise-DSL sigmas in a group of their
own at `sigma_lr` (non-pairwise sigmas live in the encoder and decoder and
take the main lr, as in the reference), and a second Adam over the
discriminator. `torch.optim.Adam` with eps 1e-8 is the same update as
`optax.adam`; with `adam_mu_dtype="bfloat16"` both optimizers store the
first moment in bf16, as optax's `mu_dtype` does
(favae_tpu/train/favae_state.py:48-63), through `GroupAdam` (one
`OptaxAdam` a group, as optax's multi_transform keeps one Adam state a
group). The JAX package's state is one functional pytree; here the
parameters, buffers and optimizer moments are updated in place, and
`state_dict` / `load_state_dict` carry what Orbax saves there: the model's
parameters and buffers (codebook EMA, discriminator BatchNorm statistics),
both optimizers and the step, plus the state of `generator`, the
train step's source of random draws (the quantizer options'), so that a
resumed run draws what an uninterrupted one would. The frozen LPIPS is
not saved; it comes from `--lpips_ckpt`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from favae_tpu_torch.config import LossConfig, TrainConfig, VQGANConfig
from favae_tpu_torch.models.lpips import LPIPS
from favae_tpu_torch.models.vqgan import VQGANFCM, build_model
from favae_tpu_torch.train.adam import OptaxAdam


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


class GroupAdam:
    """Adam over groups of parameters, each with its own lr and its own
    `OptaxAdam` state (optax's multi_transform of adam chains), with the
    first moment stored in `mu_dtype`; the part of `torch.optim.Adam`'s
    interface that the train step and the checkpoints use."""

    def __init__(self, groups: List[Tuple[List[torch.nn.Parameter], float]],
                 train_cfg: TrainConfig, mu_dtype: torch.dtype):
        self.parts = [(OptaxAdam(params, train_cfg.adam_b1,
                                 train_cfg.adam_b2, mu_dtype=mu_dtype), lr)
                      for params, lr in groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for adam, _ in self.parts:
            for p in adam.params:
                p.grad = None

    def step(self) -> None:
        for adam, lr in self.parts:
            adam.step(lr)

    def state_dict(self) -> Dict:
        return {"groups": [adam.state_dict() for adam, _ in self.parts]}

    def load_state_dict(self, sd: Dict) -> None:
        if len(sd["groups"]) != len(self.parts):
            raise ValueError("the checkpoint's optimizer has another number "
                             "of parameter groups")
        for (adam, _), part in zip(self.parts, sd["groups"]):
            adam.load_state_dict(part)


Optimizer = Union[torch.optim.Adam, GroupAdam]


def make_optimizers(model: VQGANFCM, train_cfg: TrainConfig, lr: float
                    ) -> Tuple[Optimizer, Optimizer]:
    main, sigma, disc = split_params(model)
    groups_g = [(main, lr)] + ([(sigma, train_cfg.sigma_lr)] if sigma else [])
    if train_cfg.adam_mu_dtype != "float32":
        mu = getattr(torch, train_cfg.adam_mu_dtype)
        return (GroupAdam(groups_g, train_cfg, mu),
                GroupAdam([(disc, lr)], train_cfg, mu))
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
    opt_g: Optimizer
    opt_d: Optimizer
    generator: Optional[torch.Generator] = None
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
        # seed + 1, as the JAX trainer's PRNGKey(seed + 1) for its steps
        gen = torch.Generator(device=dev).manual_seed(train_cfg.seed + 1)
        return cls(model=model, lpips=lpips, opt_g=opt_g, opt_d=opt_d,
                   generator=gen)

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore a `state_dict` into this state, whose optimizers must be
        built from the same configs: `torch.optim.Adam` matches its state to
        the parameters by their order in the groups, and the pairwise-sigma
        group exists only for pairwise DSL."""
        self.model.load_state_dict(sd["model"], strict=True)
        for opt, key in ((self.opt_g, "opt_g"), (self.opt_d, "opt_d")):
            opt.load_state_dict(_steps_on_host(sd[key])
                                if isinstance(opt, torch.optim.Optimizer)
                                else sd[key])
        self.step = int(sd["step"])
        if "generator" in sd:  # checkpoints from before the draws lack it
            self.generator.set_state(sd["generator"].cpu())


def _steps_on_host(opt_sd: Dict) -> Dict:
    """An Adam state_dict with each parameter's `step` counter on the CPU,
    where Adam keeps it (`load_state_dict` leaves it where the checkpoint
    was loaded to, and a counter on the card would cost a sync a
    parameter each step)."""
    return {**opt_sd, "state": {
        i: {k: (v.cpu() if k == "step" else v) for k, v in st.items()}
        for i, st in opt_sd["state"].items()}}
