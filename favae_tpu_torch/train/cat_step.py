"""CAT train step and optimizer: AdamW with minGPT-style decay masking
(port of favae_tpu/train/cat_step.py).

reference: cat_scripts/train_cat.py:69-109 (hot loop) and
models/txt_cond_transformer.py:238-265 (configure_optimizers). Decay rules:

* no weight decay: the weights of the nn.Embedding modules (the token
  embedding, which is also the tied logits head, and every RelPosBias2d
  table) and anything named "bias";
* weight decay 0.01: everything else, including the LayerNorm gammas, the
  axial positional embeddings, the start token and the null kv (the
  reference's filter excludes only torch's own LayerNorm and Embedding).

`CATAdamW` is `train/adam.py`'s optax-exact update with the decay mask
and the moments' storage dtypes (`adam_mu_dtype`, `adam_nu_dtype`); with
f32 moments it is `optax.adamw` (and `torch.optim.AdamW`). The
frozen FA-VAE and CLIP encodes run without a graph inside the
full-pipeline step; the latent step starts from their cached outputs.
Under data parallelism (`dp`) the gradients are averaged over dp before
the update and the loss is the mean over dp; a tensor-parallel GPT
(`parallel.sharding`) takes its collectives inside its forward and
backward, and its optimizer holds moments for this rank's slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from favae_tpu_torch.config import CATConfig
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.models.txt_cond import CATModel
from favae_tpu_torch.parallel.mesh import all_reduce_grads_, all_reduce_mean
from favae_tpu_torch.train.adam import OptaxAdam

Metrics = Dict[str, torch.Tensor]


def decay_mask(gpt: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies."""
    embeds = {f"{n}.weight" if n else "weight"
              for n, m in gpt.named_modules() if isinstance(m, nn.Embedding)}
    return {n: not (n in embeds or n.split(".")[-1] == "bias")
            for n, _ in gpt.named_parameters()}


class CATAdamW(OptaxAdam):
    """AdamW over a GPT's parameters with `decay_mask`, b1 0.9, b2 0.95,
    eps 1e-8, weight decay 0.01 (the CATConfig's), and storage dtypes for
    the two moments (`OptaxAdam`). `step(lr)` applies one update from the
    parameters' `.grad`."""

    def __init__(self, gpt: GPT, cfg: CATConfig, eps: float = 1e-8):
        mask = decay_mask(gpt)
        named = [(n, p) for n, p in gpt.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        super().__init__(
            [p for _, p in named], cfg.adam_b1, cfg.adam_b2, eps,
            cfg.weight_decay,
            [i for i, (n, _) in enumerate(named) if mask[n]],
            getattr(torch, cfg.adam_mu_dtype),
            getattr(torch, cfg.adam_nu_dtype))


@dataclasses.dataclass
class CATTrainState:
    cat: CATModel
    opt: CATAdamW
    lr_schedule: Callable[[int], float]
    step: int = 0


def _split(batch: Sequence[torch.Tensor], grad_accum: int
           ) -> List[Tuple[torch.Tensor, ...]]:
    b = batch[0].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum={grad_accum}")
    return list(zip(*(t.chunk(grad_accum) for t in batch)))


def _train_step(state: CATTrainState, loss_for: Callable, batch, *,
                generator: torch.Generator, cond_keep, grad_accum: int,
                dp=None) -> Tuple[CATTrainState, Metrics]:
    """value and grad of `loss_for(*micro_batch, cond_keep)` over
    `grad_accum` equal micro-batches (grads and loss summed, then divided
    by `grad_accum`, favae_tpu/train/cat_step.py:174-205), averaged over
    `dp`, then one AdamW update at the schedule's lr of this update."""
    params = state.opt.params
    for p in params:
        p.grad = None
    keeps = (cond_keep.chunk(grad_accum) if cond_keep is not None
             else (None,) * grad_accum)
    total = None
    for micro, keep in zip(_split(batch, grad_accum), keeps):
        loss = loss_for(*micro, generator=generator, cond_keep=keep)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if grad_accum > 1:
        total = total / grad_accum
        torch._foreach_div_([p.grad for p in params], grad_accum)
    all_reduce_grads_(params, dp)
    state.opt.step(state.lr_schedule(state.step))
    state.step += 1
    return state, {"loss_gpt": all_reduce_mean(total, dp)}


def make_cat_train_step(grad_accum: int = 1, dp=None) -> Callable:
    """step(state, x, text_ids, generator, cond_keep=None): images (B, H, W,
    3) in [-1, 1] and CLIP text ids (B, 77) through the frozen towers and
    the GPT. `cond_keep` (B,) bool replaces the conditioning draw. Under
    `dp` the batch is this rank's part of the global one."""

    def train_step(state, x, text_ids, generator, cond_keep=None):
        return _train_step(state, state.cat.gpt_loss, (x, text_ids),
                           generator=generator, cond_keep=cond_keep,
                           grad_accum=grad_accum, dp=dp)

    return train_step


def make_cat_latent_train_step(grad_accum: int = 1, dp=None) -> Callable:
    """step(state, z, embeds, mask, generator, cond_keep=None) over cached
    latents (`CATModel.gpt_loss_from_latents`): the frozen towers do not
    run, and with the same latents the update is the full step's."""

    def train_step(state, z, embeds, mask, generator, cond_keep=None):
        return _train_step(state, state.cat.gpt_loss_from_latents,
                           (z, embeds, mask), generator=generator,
                           cond_keep=cond_keep, grad_accum=grad_accum, dp=dp)

    return train_step


@torch.no_grad()
def cat_eval_step(state: CATTrainState, x, text_ids) -> Metrics:
    return {"loss_gpt": state.cat.gpt_loss(x, text_ids, train=False)}


@torch.no_grad()
def cat_latent_eval_step(state: CATTrainState, z, embeds, mask) -> Metrics:
    return {"loss_gpt": state.cat.gpt_loss_from_latents(z, embeds, mask,
                                                        train=False)}
