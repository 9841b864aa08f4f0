"""GroupNorm with an optional SiLU through `torch.nn.functional.group_norm`
in float32: the reference for the port's GroupNorm kernels (rows 2-4),
differentiable by autograd. Output in `out_dtype`, channels_last."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-5,
                   act: Optional[str] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    if act == "silu":
        y = F.silu(y)
    elif act is not None:
        raise ValueError(f"group_norm_act: unknown act {act!r}")
    return y.to(out_dtype or x.dtype, memory_format=torch.channels_last)
