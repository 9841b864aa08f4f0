"""Focal Frequency Loss (Jiang et al., ICCV 2021) and its feature-tap form.

Port of `favae_tpu/ops/ffl.py`, the pip package `focal-frequency-loss`
semantics with alpha 1 and the defaults the reference uses:

  dF = DFT(pred - target), ortho norm (the DFT is linear, so the difference
       is transformed once)
  d  = |dF|^2, w = |dF|^alpha / max over H, W of |dF|^alpha per (n, c),
       NaN -> 0, clipped to [0, 1], detached
  loss = mean(w * d) * loss_weight

The spectra come back in `compute_dtype` (the preset's `spectral_dtype`);
the distance and weight math is f32. Tensors are NHWC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from favae_tpu_torch.ops.dft import dft2_real_nhwc


def _dtype(d) -> Optional[torch.dtype]:
    return getattr(torch, d) if isinstance(d, str) else d


def focal_frequency_loss(pred: torch.Tensor, target: torch.Tensor,
                         loss_weight: float = 1.0, alpha: float = 1.0,
                         log_matrix: bool = False, batch_matrix: bool = False,
                         matrix: Optional[torch.Tensor] = None,
                         compute_dtype=None) -> torch.Tensor:
    """FFL between NHWC `pred` and `target`; a scalar
    (favae_tpu/ops/ffl.py:34-86)."""
    diff = pred.float() - target.float()
    re, im = dft2_real_nhwc(diff, norm="ortho",
                            compute_dtype=_dtype(compute_dtype))
    re, im = re.float(), im.float()
    dist = re * re + im * im

    if matrix is not None:
        w = matrix.detach()
    else:
        with torch.no_grad():
            if log_matrix:
                w = torch.log(torch.pow(torch.sqrt(dist), alpha) + 1.0)
                denom = (w.amax() if batch_matrix
                         else w.amax(dim=(1, 2), keepdim=True))
                w = w / denom
            else:
                # |dF|^a / max |dF|^a == (d / max d)^(a/2): normalise after
                # the max, without the sqrt array
                denom = (dist.amax() if batch_matrix
                         else dist.amax(dim=(1, 2), keepdim=True))
                ratio = dist / denom
                w = (torch.sqrt(ratio) if alpha == 1.0
                     else torch.pow(ratio, alpha * 0.5))
            w = torch.nan_to_num(w, nan=0.0).clamp_(0.0, 1.0)
    return torch.mean(w * dist) * loss_weight


def feature_tap_ffl(enc_feats: Sequence[torch.Tensor],
                    dec_feats: Sequence[torch.Tensor],
                    loss_weight: float = 1.0, alpha: float = 1.0,
                    compute_dtype=None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """FFL over mirror-paired taps: encoder tap i against decoder tap
    n-1-i (favae_tpu/ops/ffl.py:89-111). Returns (mean, per-pair list)."""
    n = len(enc_feats)
    losses = [focal_frequency_loss(dec_feats[n - 1 - i], enc_feats[i],
                                   loss_weight=loss_weight, alpha=alpha,
                                   compute_dtype=compute_dtype)
              for i in range(n)]
    return sum(losses) / n, losses
