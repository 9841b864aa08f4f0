"""Tensor parallelism of the CAT GPT (port of
favae_tpu/parallel/sharding.py).

The rule is the JAX package's `gpt_param_pspec`: the Q projection and the
first FF matmul split by output (column parallel), the attention output
projection and the second FF matmul by input (row parallel), everything
else replicated (the single-head `to_kv`, norms, embeddings, the null kv,
the relative position bias). In the port's (out, in) weight layout a
column split cuts dim 0 and a row split dim 1.

GSPMD inserts the collectives in the JAX package; here the GPT's modules
call the two functions below (Megatron's f and g) where activations
enter and leave a split region, and the few places where a replicated
tensor meets a split one take the rest (`models/gpt.py`): the FF's
LayerNorm over the split 4x width sums its statistics over tp, and the
shared K/V head, the relative position bias table and a gamma folded into
a split weight take their gradient summed over tp.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from favae_tpu_torch.parallel.mesh import (Group, all_gather_dim, collective,
                                           spans)

COLUMN, ROW = 0, 1  # the weight dim that a split cuts


def gpt_param_spec(name: str, param: Optional[torch.Tensor] = None
                   ) -> Optional[int]:
    """The dim of the GPT parameter `name` split over tp (COLUMN or ROW),
    or None where it is replicated (favae_tpu/parallel/sharding.py:20-31)."""
    parts = name.split(".")
    if parts[-1] != "weight" or parts[0] != "blocks":
        return None
    if parts[-3] == "to_q" or parts[2:] == ["2", "1", "weight"]:
        return COLUMN
    if parts[-3] == "to_out" or parts[2:] == ["2", "4", "weight"]:
        return ROW
    return None


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over tp (each rank
    differentiates only its split of what follows)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        collective(dist.all_reduce, dx, group=ctx.g.group)
        return dx, None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over tp of the ranks' partial products (in f32); identity
    backward (what follows is replicated, so each rank's gradient is
    whole)."""

    @staticmethod
    def forward(ctx, x, g):
        out = x.float().contiguous().clone()
        collective(dist.all_reduce, out, group=g.group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tp(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    if not spans(g):
        return x
    return _CopyToTP.apply(x, g)


def reduce_from_tp(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    if not spans(g):
        return x
    return _ReduceFromTP.apply(x, g)


def tp_slice(t: torch.Tensor, dim: Optional[int], g: Optional[Group]
             ) -> torch.Tensor:
    """This rank's part of a full tensor split along `dim` (all of it
    where `dim` is None)."""
    if dim is None or g is None:
        return t
    n = t.shape[dim]
    if n % g.size:
        raise ValueError(f"width {n} does not divide by tp={g.size}")
    return t.narrow(dim, g.rank * (n // g.size), n // g.size)


def shard_gpt_(gpt: nn.Module, g: Group) -> nn.Module:
    """Keep this rank's slice of each split weight of `gpt` (in place) and
    give its attention and FF modules the tp group. Raises where the heads
    or the FF width do not divide by tp."""
    from favae_tpu_torch.models.gpt import FeedForward, MultiQueryAttention
    cfg = gpt.cfg
    if cfg.n_head % g.size or (4 * cfg.n_embed) % g.size:
        raise ValueError(f"tp={g.size} must divide the {cfg.n_head} heads "
                         f"and the FF width {4 * cfg.n_embed}")
    if g.size == 1:
        return gpt
    for name, p in list(gpt.named_parameters()):
        dim = gpt_param_spec(name, p)
        if dim is None:
            continue
        owner = gpt.get_submodule(name.rsplit(".", 1)[0])
        owner.weight = nn.Parameter(tp_slice(p.detach(), dim, g).clone(),
                                    requires_grad=p.requires_grad)
    for m in gpt.modules():
        if isinstance(m, (MultiQueryAttention, FeedForward)):
            m.tp = g
    return gpt


def gather_gpt_state(sd: Dict[str, torch.Tensor], g: Optional[Group]
                     ) -> Dict[str, torch.Tensor]:
    """A sharded GPT's named tensors (parameters, or moments named as
    them) as full tensors, every rank of tp taking part."""
    if not spans(g):
        return dict(sd)
    return {k: (all_gather_dim(v, d, g) if (d := gpt_param_spec(k))
                is not None else v) for k, v in sd.items()}


def shard_gpt_state(sd: Dict[str, torch.Tensor], g: Optional[Group]
                    ) -> Dict[str, torch.Tensor]:
    """Full named tensors cut to this rank's slices."""
    if not spans(g):
        return dict(sd)
    return {k: tp_slice(v, gpt_param_spec(k), g) for k, v in sd.items()}
