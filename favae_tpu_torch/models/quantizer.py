"""Vector quantizer with EMA codebooks (port of
favae_tpu/models/quantizer.py).

The codebook lives in buffers named as the reference's codebook
(`quantizer._codebook.embed` with a leading num_codebooks axis of 1,
favae_tpu/utils/torch_export.py:148-155), so a reference-format state_dict
loads strictly; `CodebookState` is the same codebook as plain tensors, the
form the JAX package passes around. All quantizer math is f32.

`codebook_lookup(train=True)` returns the EMA-updated state as new tensors,
as the JAX package does; the train step then copies it into the module's
buffers in place (`VectorQuantize.set_state`).

Every temperature-0 lookup goes to `ops.vq` (the CUDA kernel on the card).
The JAX package gates its TPU kernel on N*K >= 2^22
(favae_tpu/models/quantizer.py:138-143) because a small Pallas call costs
more than XLA's fused matmul + argmax there; on the card the kernel needs no
(N, K) scores in device memory at any size, so the port has no gate.
Dead-code expiry, k-means init, gumbel sampling and the orthogonal
regulariser are not used by the published presets and are not ported yet:
they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from favae_tpu_torch.config import QuantizerConfig
from favae_tpu_torch.ops.vq import vq_nearest_cosine, vq_nearest_euclidean


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis (favae_tpu quantizer.py:35-38)."""
    return F.normalize(t, dim=-1, eps=eps)


@dataclasses.dataclass
class CodebookState:
    """One codebook as plain f32 tensors: embed (K, D), cluster_size (K,),
    embed_avg (K, D)."""

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor


def init_codebook_state(cfg: QuantizerConfig,
                        generator: Optional[torch.Generator] = None
                        ) -> CodebookState:
    """kaiming_uniform over (K, D), bound 1/sqrt(D), l2-normalised for the
    cosine codebook (favae_tpu quantizer.py:88-102)."""
    d = cfg.codebook_dim or cfg.dim
    k = cfg.codebook_size
    bound = 1.0 / d ** 0.5
    embed = (torch.rand((k, d), generator=generator) * 2.0 - 1.0) * bound
    if cfg.use_cosine_sim:
        embed = l2norm(embed)
    return CodebookState(embed=embed, cluster_size=torch.zeros(k),
                         embed_avg=embed.clone())


def check_ported(cfg: QuantizerConfig) -> None:
    """Raise for the quantizer options this package does not port yet."""
    for name, on in (("gumbel sampling (sample_codebook_temp)",
                      cfg.sample_codebook_temp != 0.0),
                     ("dead-code expiry (threshold_ema_dead_code)",
                      cfg.threshold_ema_dead_code > 0),
                     ("k-means codebook init (kmeans_init)", cfg.kmeans_init),
                     ("the orthogonal regulariser (orthogonal_reg_weight)",
                      cfg.orthogonal_reg_weight > 0)):
        if on:
            raise NotImplementedError(
                f"{name} is not yet ported to favae_tpu_torch")


def laplace_smoothing(x: torch.Tensor, n_categories: int,
                      eps: float = 1e-5) -> torch.Tensor:
    return (x + eps) / (torch.sum(x, dim=-1, keepdim=True)
                        + n_categories * eps)


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


@torch.no_grad()
def _ema_update(cfg: QuantizerConfig, state: CodebookState,
                flatten: torch.Tensor, embed_n: Optional[torch.Tensor],
                idx: torch.Tensor) -> CodebookState:
    """The new EMA state (favae_tpu/models/quantizer.py:223-257)."""
    k, decay = cfg.codebook_size, cfg.decay
    bins, embed_sum = code_stats(flatten, idx, k)
    cluster = state.cluster_size * decay + bins * (1.0 - decay)
    if cfg.use_cosine_sim:
        # normalised batch means; empty bins keep the current code
        zero = (bins == 0)[:, None]
        normed = l2norm(embed_sum / torch.where(bins == 0, 1.0, bins)[:, None])
        normed = torch.where(zero, embed_n, normed)
        embed = state.embed * decay + normed * (1.0 - decay)
        return CodebookState(embed=embed, cluster_size=cluster,
                             embed_avg=state.embed_avg)
    if cfg.compat_stale_embed_avg:
        avg = state.embed_avg  # the reference never updates it
    else:
        avg = state.embed_avg * decay + embed_sum * (1.0 - decay)
    smoothed = laplace_smoothing(cluster, k, cfg.eps) * torch.sum(cluster)
    return CodebookState(embed=avg / smoothed[:, None], cluster_size=cluster,
                         embed_avg=avg)


def codebook_lookup(cfg: QuantizerConfig, state: CodebookState,
                    x: torch.Tensor, *, train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, CodebookState]:
    """Quantize (N, D) -> (quantize (N, D) f32, indices (N,) int64, state),
    the state EMA-updated when `train` (cosine: reference
    models/l2_quantize.py:391-444; euclidean: :264-306). The lookup needs no
    gradient: its inputs are detached."""
    if train or cfg.sample_codebook_temp != 0.0:
        check_ported(cfg)
    x = x.float()
    with torch.no_grad():
        if cfg.use_cosine_sim:
            flatten, embed_n = l2norm(x), l2norm(state.embed)
            idx = vq_nearest_cosine(flatten, embed_n)
        else:
            flatten, embed_n = x, None
            idx = vq_nearest_euclidean(flatten, state.embed)
        idx = idx.long()
        quantize = state.embed[idx]  # the codes before this step's update
        if train:
            state = _ema_update(cfg, state, flatten, embed_n, idx)
    return quantize, idx, state


class _Codebook(nn.Module):
    """Buffers of the reference's CosineSimCodebook / EuclideanCodebook."""

    def __init__(self, k: int, d: int, euclidean: bool):
        super().__init__()
        self.register_buffer("initted", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(1, k))
        self.register_buffer("embed", torch.zeros(1, k, d))
        if euclidean:
            self.register_buffer("embed_avg", torch.zeros(1, k, d))


class VectorQuantize(nn.Module):
    """Image-fmap vector quantizer (reference: models/l2_quantize.py:448-595)
    with the optional f32 `project_in`/`project_out`."""

    def __init__(self, cfg: QuantizerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.codebook_dim or cfg.dim
        if cfg.codebook_dim is not None and cfg.codebook_dim != cfg.dim:
            self.project_in = nn.Linear(cfg.dim, cfg.codebook_dim)
            self.project_out = nn.Linear(cfg.codebook_dim, cfg.dim)
        else:
            self.project_in = self.project_out = None
        self._codebook = _Codebook(cfg.codebook_size, d,
                                   euclidean=not cfg.use_cosine_sim)

    def state(self) -> CodebookState:
        cb = self._codebook
        embed = cb.embed[0]
        avg = cb.embed_avg[0] if hasattr(cb, "embed_avg") else embed
        return CodebookState(embed=embed, cluster_size=cb.cluster_size[0],
                             embed_avg=avg)

    @torch.no_grad()
    def set_state(self, state: CodebookState) -> None:
        cb = self._codebook
        cb.embed.copy_(state.embed[None])
        cb.cluster_size.copy_(state.cluster_size[None])
        if hasattr(cb, "embed_avg"):
            cb.embed_avg.copy_(state.embed_avg[None])

    def forward(self, x: torch.Tensor, state: Optional[CodebookState] = None,
                *, train: bool = False):
        """x (B, C=dim, H, W) -> (quantized (B, dim, H, W) f32 channels_last,
        indices (B, H, W) int64, loss (scalar f32), new state). `state`
        defaults to the module's codebook. With `train` the output is the
        straight-through estimate, the loss the weighted commitment loss and
        the state EMA-updated (favae_tpu/models/quantizer.py:281-319)."""
        state = state or self.state()
        b, c, h, w = x.shape
        z = x.permute(0, 2, 3, 1).reshape(b * h * w, c).float()
        if self.project_in is not None:
            z = self.project_in(z)
        quantize, idx, state = codebook_lookup(self.cfg, state, z,
                                               train=train)
        loss = torch.zeros((), dtype=torch.float32, device=z.device)
        if train:
            quantize = z + (quantize - z).detach()
            if self.cfg.commitment_weight > 0:
                commit = torch.mean((quantize.detach() - z) ** 2)
                loss = loss + commit * self.cfg.commitment_weight
        if self.project_out is not None:
            quantize = self.project_out(quantize)
        out = quantize.reshape(b, h, w, self.cfg.dim).permute(0, 3, 1, 2)
        return out, idx.reshape(b, h, w), loss, state

    def decode_indices(self, indices: torch.Tensor,
                       state: Optional[CodebookState] = None) -> torch.Tensor:
        """Indices (B, H, W) -> codebook entries (B, dim, H, W), projected
        back to `dim` (favae_tpu quantizer.py:321-329)."""
        state = state or self.state()
        z = state.embed[indices]
        if self.project_out is not None:
            z = self.project_out(z)
        return z.permute(0, 3, 1, 2)
