"""The projected cosine quantizer of the port's `models/quantizer.py`, the
benchmark's reference for the configurations whose codebook is wider than
the latent (`codebook_dim` != `dim`; imports nothing of the port; see
../README.md).

`project_in` maps each latent vector (f32) to `codebook_dim`, the nearest
code is found there by `quantizer.codebook_lookup` (a float32 matmul and
argmax over the l2-normed sides), and `project_out` maps the code back to
`dim`, for the decoder and for `decode_indices` alike.

Departures from `favae_tpu_torch/models/quantizer.py`: the cosine
codebook only, looked up in eval (no straight-through estimate, no loss,
no EMA update: reconstruction and decoding only), none of the train
options; `quantizer.check_carried` refuses the others. The projections
are `blocks.Linear` computing in float32, so that the control's precision
(`precision.use_fp8`) reaches them as it reaches every product. The module
and buffer names are the port's (`project_in`, `project_out`,
`_codebook.embed` of `codebook_dim` columns), so one state_dict loads into
both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from benchmark.reference.blocks import Linear
from benchmark.reference.config import QuantizerConfig
from benchmark.reference.quantizer import (CodebookState, _Codebook,
                                           check_carried, codebook_lookup)


class VectorQuantize(nn.Module):
    """Image-fmap vector quantizer with the f32 `project_in`/`project_out`
    (reference: models/l2_quantize.py:448-595)."""

    def __init__(self, cfg: QuantizerConfig):
        super().__init__()
        if cfg.codebook_dim in (None, cfg.dim):
            raise NotImplementedError(
                "the projected reference quantizer needs a codebook_dim "
                "other than dim (quantizer.VectorQuantize has none)")
        check_carried(dataclasses.replace(cfg, codebook_dim=None))
        self.cfg = cfg
        self.project_in = Linear(cfg.dim, cfg.codebook_dim, torch.float32)
        self.project_out = Linear(cfg.codebook_dim, cfg.dim, torch.float32)
        self._codebook = _Codebook(cfg.codebook_size, cfg.codebook_dim)

    def state(self) -> CodebookState:
        cb = self._codebook
        return CodebookState(embed=cb.embed[0],
                             cluster_size=cb.cluster_size[0])

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C=dim, H, W) -> the projected rows (B*H*W, codebook_dim)
        f32 that the codes are searched against."""
        b, c, h, w = x.shape
        return self.project_in(
            x.permute(0, 2, 3, 1).reshape(b * h * w, c).float()).float()

    def forward(self, x: torch.Tensor, state: Optional[CodebookState] = None,
                *, train: bool = False):
        """x (B, C=dim, H, W) -> (quantized (B, dim, H, W) f32 channels_last,
        indices (B, H, W) int64, loss (scalar f32, 0), state)."""
        if train:
            raise NotImplementedError(
                "the projected reference quantizer does not train")
        state = state or self.state()
        b, _, h, w = x.shape
        quantize, idx, state = codebook_lookup(self.cfg, state,
                                               self.project(x))
        out = self.project_out(quantize).float()
        out = out.reshape(b, h, w, self.cfg.dim).permute(0, 3, 1, 2)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        return out, idx.reshape(b, h, w), loss, state

    def decode_indices(self, indices: torch.Tensor,
                       state: Optional[CodebookState] = None) -> torch.Tensor:
        """Indices (B, H, W) -> codebook entries projected back to `dim`,
        (B, dim, H, W) (favae_tpu quantizer.py:321-329)."""
        state = state or self.state()
        return self.project_out(state.embed[indices]).float() \
            .permute(0, 3, 1, 2)
