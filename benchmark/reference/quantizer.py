"""Frozen copy of the port's `models/quantizer.py` cut to what the
benchmark's configurations run, the benchmark's reference (imports nothing
of the port; see ../README.md): the cosine EMA codebook with the nearest
code by a float32 matmul and argmax, no projection. Gumbel sampling, the
orthogonal regulariser, k-means, dead-code expiry, the Euclidean codebook
and data parallelism are not carried: a configuration that asks for one
raises.

The codebook lives in buffers named as the reference's codebook
(`quantizer._codebook.embed` with a leading num_codebooks axis of 1), so a
reference-format state_dict loads strictly; `CodebookState` is the same
codebook as plain tensors. All quantizer math is f32.

`codebook_lookup(train=True)` returns the EMA-updated state as new tensors;
the train step then copies it into the module's buffers in place
(`VectorQuantize.set_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import QuantizerConfig
from benchmark.reference.vq import vq_nearest_cosine


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis (favae_tpu quantizer.py:35-38)."""
    return F.normalize(t, dim=-1, eps=eps)


def check_carried(cfg: QuantizerConfig) -> None:
    """Raise where `cfg` asks for an option this copy does not carry."""
    off = {"use_cosine_sim": not cfg.use_cosine_sim,
           "codebook_dim": cfg.codebook_dim not in (None, cfg.dim),
           "sample_codebook_temp": cfg.sample_codebook_temp != 0.0,
           "threshold_ema_dead_code": cfg.threshold_ema_dead_code > 0,
           "kmeans_init": cfg.kmeans_init,
           "orthogonal_reg_weight": cfg.orthogonal_reg_weight > 0,
           "compat_stale_embed_avg": cfg.compat_stale_embed_avg}
    asked = [k for k, v in off.items() if v]
    if asked:
        raise NotImplementedError(
            f"the benchmark's reference quantizer does not carry {asked}")


@dataclasses.dataclass
class CodebookState:
    """One codebook as plain f32 tensors: embed (K, D), cluster_size (K,)."""

    embed: torch.Tensor
    cluster_size: torch.Tensor


def code_stats(flatten: torch.Tensor, idx: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code counts (K,) and sums (K, D) by `index_add_`
    (favae_tpu/models/quantizer.py:174-179)."""
    bins = torch.zeros(k, dtype=torch.float32, device=flatten.device)
    bins.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    sums = torch.zeros((k, flatten.shape[-1]), dtype=torch.float32,
                       device=flatten.device)
    sums.index_add_(0, idx, flatten)
    return bins, sums


def _ema_update(cfg: QuantizerConfig, state: CodebookState,
                flatten: torch.Tensor, embed_n: torch.Tensor,
                idx: torch.Tensor) -> CodebookState:
    """The new EMA state (favae_tpu/models/quantizer.py:223-257): the counts
    and the normalised batch means; empty bins keep the current code."""
    decay = cfg.decay
    bins, embed_sum = code_stats(flatten, idx, cfg.codebook_size)
    cluster = state.cluster_size * decay + bins * (1.0 - decay)
    zero = (bins == 0)[:, None]
    normed = l2norm(embed_sum / torch.where(bins == 0, 1.0, bins)[:, None])
    normed = torch.where(zero, embed_n, normed)
    embed = state.embed * decay + normed * (1.0 - decay)
    return CodebookState(embed=embed, cluster_size=cluster)


def codebook_lookup(cfg: QuantizerConfig, state: CodebookState,
                    x: torch.Tensor, *, train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, CodebookState]:
    """Quantize (N, D) -> (quantize (N, D) f32, indices (N,) int64, state),
    the state EMA-updated when `train` (reference models/l2_quantize.py:
    391-444). The lookup needs no gradient."""
    x = x.float()
    with torch.no_grad():
        embed_n = l2norm(state.embed)
        flatten = l2norm(x)
        idx = vq_nearest_cosine(flatten, embed_n).long()
        quantize = state.embed[idx]  # the codes before this step's update
        if train:
            state = _ema_update(cfg, state, flatten, embed_n, idx)
    return quantize, idx, state


class _Codebook(nn.Module):
    """Buffers of the reference's CosineSimCodebook."""

    def __init__(self, k: int, d: int):
        super().__init__()
        self.register_buffer("initted", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(1, k))
        self.register_buffer("embed", torch.zeros(1, k, d))


class VectorQuantize(nn.Module):
    """Image-fmap vector quantizer (reference: models/l2_quantize.py:448-595)."""

    def __init__(self, cfg: QuantizerConfig):
        super().__init__()
        check_carried(cfg)
        self.cfg = cfg
        self._codebook = _Codebook(cfg.codebook_size, cfg.dim)

    def state(self) -> CodebookState:
        cb = self._codebook
        return CodebookState(embed=cb.embed[0],
                             cluster_size=cb.cluster_size[0])

    @torch.no_grad()
    def set_state(self, state: CodebookState) -> None:
        cb = self._codebook
        cb.embed.copy_(state.embed[None])
        cb.cluster_size.copy_(state.cluster_size[None])

    def forward(self, x: torch.Tensor, state: Optional[CodebookState] = None,
                *, train: bool = False):
        """x (B, C=dim, H, W) -> (quantized (B, dim, H, W) f32 channels_last,
        indices (B, H, W) int64, loss (scalar f32), new state). `state`
        defaults to the module's codebook. With `train` the output is the
        straight-through estimate, the loss the weighted commitment loss,
        and the state EMA-updated (favae_tpu/models/quantizer.py:281-319)."""
        cfg = self.cfg
        state = state or self.state()
        b, c, h, w = x.shape
        z = x.permute(0, 2, 3, 1).reshape(b * h * w, c).float()
        quantize, idx, state = codebook_lookup(cfg, state, z, train=train)
        loss = torch.zeros((), dtype=torch.float32, device=z.device)
        if train:
            quantize = z + (quantize - z).detach()
            if cfg.commitment_weight > 0:
                commit = torch.mean((quantize.detach() - z) ** 2)
                loss = loss + commit * cfg.commitment_weight
        out = quantize.reshape(b, h, w, cfg.dim).permute(0, 3, 1, 2)
        return out, idx.reshape(b, h, w), loss, state

    def decode_indices(self, indices: torch.Tensor,
                       state: Optional[CodebookState] = None) -> torch.Tensor:
        """Indices (B, H, W) -> codebook entries (B, dim, H, W)
        (favae_tpu quantizer.py:321-329)."""
        state = state or self.state()
        return state.embed[indices].permute(0, 3, 1, 2)
