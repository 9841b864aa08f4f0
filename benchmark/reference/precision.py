"""The control's precision: float8 (e4m3) inputs to every convolution and
matrix product, the step below the bfloat16 that the configurations state.

`fake_fp8` rounds a tensor to e4m3 under one scale a tensor (its largest
magnitude mapped to e4m3's 448, as a per-tensor fp8 recipe scales) and
returns it in float32; the gradient passes straight through. `use_fp8`
turns it on for the convolutions, linear layers and attention products of a
reference model built from the copies beside this file: their inputs,
weights and outputs are rounded, as the program's bfloat16 rounds its
operands and stores its activations."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    f = t.float()
    with torch.no_grad():
        scale = f.abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (f / scale).to(torch.float8_e4m3fn).float() * scale
    return f + (q - f).detach()


def use_fp8(model: torch.nn.Module) -> None:
    for m in model.modules():
        if hasattr(m, "fp8"):
            m.fp8 = True
