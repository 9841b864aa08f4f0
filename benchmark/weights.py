"""Seeded random weights made on the device in one large draw, then cut to
the shapes of a template state_dict (taken from the reference's modules on
the `meta` device, so no weight of the port's own initialisation is used).
The same dict is loaded into the port and into the reference."""

from __future__ import annotations

from typing import Callable, Dict

import torch

Rule = Callable[[str, torch.Tensor], torch.Tensor]


def default_rule(name: str, r: torch.Tensor) -> torch.Tensor:
    """A standard normal draw `r` shaped as the tensor `name`, scaled to a
    usual initialisation: matrices and kernels by 1/sqrt(fan in), norm
    scales about 1, biases small; running statistics at their start."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean", "cluster_size"):
        return torch.zeros_like(r)
    if leaf in ("running_var", "initted"):
        return torch.ones_like(r)
    if r.dim() >= 2:
        return r * (r[0].numel() ** -0.5)
    if leaf == "bias":
        return 0.02 * r
    return 1.0 + 0.1 * r


def make_state(template: Dict[str, torch.Tensor], seed: int, device,
               rule: Rule = default_rule) -> Dict[str, torch.Tensor]:
    floats = {k: v for k, v in template.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for k, v in template.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = v.numel()
        out[k] = rule(k, flat[off:off + n].view(v.shape)).to(v.dtype)
        off += n
    return out
