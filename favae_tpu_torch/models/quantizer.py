"""Vector quantizer, inference half (port of favae_tpu/models/quantizer.py).

The codebook lives in buffers named as the reference's codebook
(`quantizer._codebook.embed` with a leading num_codebooks axis of 1,
favae_tpu/utils/torch_export.py:148-155), so a reference-format state_dict
loads strictly; `CodebookState` is the same codebook as plain tensors, the
form the JAX package passes around. All quantizer math is f32.

Every temperature-0 lookup goes to `ops.vq` (the CUDA kernel on the card).
The JAX package gates its TPU kernel on N*K >= 2^22
(favae_tpu/models/quantizer.py:138-143) because a small Pallas call costs
more than XLA's fused matmul + argmax there; on the card the kernel needs no
(N, K) scores in device memory at any size, so the port has no gate.
EMA updates, dead-code expiry, k-means init and gumbel sampling belong to
the training path and are not ported yet.
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


def codebook_lookup(cfg: QuantizerConfig, state: CodebookState,
                    x: torch.Tensor, *, train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (N, D) -> (quantize (N, D) f32, indices (N,) int64)."""
    if train or cfg.sample_codebook_temp != 0.0:
        raise NotImplementedError(
            "codebook EMA updates and gumbel sampling belong to the training "
            "path, which favae_tpu_torch does not port yet")
    x = x.float()
    if cfg.use_cosine_sim:
        idx = vq_nearest_cosine(l2norm(x), l2norm(state.embed))
    else:
        idx = vq_nearest_euclidean(x, state.embed)
    idx = idx.long()
    return state.embed[idx], idx


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

    def forward(self, x: torch.Tensor, state: Optional[CodebookState] = None):
        """x (B, C=dim, H, W) -> (quantized (B, dim, H, W) f32 channels_last,
        indices (B, H, W) int64). `state` defaults to the module's codebook."""
        state = state or self.state()
        b, c, h, w = x.shape
        z = x.permute(0, 2, 3, 1).reshape(b * h * w, c).float()
        if self.project_in is not None:
            z = self.project_in(z)
        quantize, idx = codebook_lookup(self.cfg, state, z)
        if self.project_out is not None:
            quantize = self.project_out(quantize)
        out = quantize.reshape(b, h, w, self.cfg.dim).permute(0, 3, 1, 2)
        return out, idx.reshape(b, h, w)

    def decode_indices(self, indices: torch.Tensor,
                       state: Optional[CodebookState] = None) -> torch.Tensor:
        """Indices (B, H, W) -> codebook entries (B, dim, H, W), projected
        back to `dim` (favae_tpu quantizer.py:321-329)."""
        state = state or self.state()
        z = state.embed[indices]
        if self.project_out is not None:
            z = self.project_out(z)
        return z.permute(0, 3, 1, 2)
