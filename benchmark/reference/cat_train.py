"""The CAT train step over cached latents, in plain PyTorch beside the
frozen copies: the teacher-forced cross-entropy of the GPT over the frozen
towers' outputs (the port's `CATModel.gpt_loss_from_latents`,
models/txt_cond.py) and AdamW with minGPT-style decay masking (the port's
`train/cat_step.py`: no decay on embeddings and biases; b1 0.9, b2 0.95,
eps 1e-8, weight decay from the configuration)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.adam import OptaxAdam


def decay_mask(gpt: nn.Module) -> Dict[str, bool]:
    embeds = {f"{n}.weight" if n else "weight"
              for n, m in gpt.named_modules() if isinstance(m, nn.Embedding)}
    return {n: not (n in embeds or n.split(".")[-1] == "bias")
            for n, _ in gpt.named_parameters()}


def adamw(gpt: nn.Module, cat_cfg) -> OptaxAdam:
    mask = decay_mask(gpt)
    named = [(n, p) for n, p in gpt.named_parameters() if p.requires_grad]
    opt = OptaxAdam([p for _, p in named], cat_cfg.adam_b1, cat_cfg.adam_b2,
                    1e-8, cat_cfg.weight_decay,
                    [i for i, (n, _) in enumerate(named) if mask[n]],
                    getattr(torch, cat_cfg.adam_mu_dtype),
                    getattr(torch, cat_cfg.adam_nu_dtype))
    opt.names = [n for n, _ in named]
    return opt


def gpt_loss(gpt, cat_cfg, z, embeds, mask, generator, train: bool = True):
    """Cross-entropy in f32 of the GPT over token ids z (B, L) with the
    text's CLIP token embeds and mask; dropout and conditioning dropout
    drawn from `generator` when training."""
    drop = cat_cfg.gpt.cond_drop_prob if train else 0.0
    logits = gpt(z[:, :-1], embeds, mask, cond_drop_prob=drop, train=train,
                 generator=generator)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           z.reshape(-1))
