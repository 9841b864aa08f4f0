"""Nearest codes by a float32 matmul and argmax over every code: the
reference for the port's `vq_nearest` kernel (row 1), for the cosine
codebook that the benchmark's configurations use."""

from __future__ import annotations

import torch


def code_scores(flatten: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """(N, K) f32 scores x.e of l2-normed sides, whose argmax is the
    nearest code."""
    return flatten.float() @ embed.float().T


def vq_nearest_cosine(flatten: torch.Tensor,
                      embed_normed: torch.Tensor) -> torch.Tensor:
    return torch.argmax(code_scores(flatten, embed_normed),
                        dim=-1).to(torch.int32)
