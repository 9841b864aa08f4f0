"""The yardstick: the H100's published peaks and the operations and bytes of
a step or a kernel call, counted from the configuration's shapes on the
reference's modules (on the `meta` device), never from the port's tensors,
so a roofline reads the same work whatever implements it.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit (the run
prints the card's power limit beside them).

The bound of a call is the larger of its operations over the peak rate and
its bytes over the HBM rate, each input byte read once and each output byte
written once (`bound`, as `chip_smoke.py::bound` of the port's smoke script
computes it; the GroupNorm rows' bytes as its rows 2-4 count them:
statistics read x, apply reads x and writes y, the backward's sums read x
and dy, its dx reads x and dy and writes dx; the per-channel vectors, a few
kB, are left out here).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "int8": 1979e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float, dtype: str = "bfloat16"
          ) -> Tuple[float, str]:
    """(least seconds, what binds: "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def count_flops(fn: Callable[[], None]) -> float:
    """Matmul and convolution FLOPs (forward and backward) of `fn()`, run
    on meta tensors; no recomputation is counted."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


class GroupNormCalls:
    """Records each GroupNorm(+act) module call of a model run on meta
    tensors: (input shape, input dtype, output dtype, backward taken)."""

    def __init__(self):
        self.calls: List[Tuple[Tuple[int, ...], torch.dtype, torch.dtype,
                               bool]] = []

    @contextlib.contextmanager
    def watch(self, *models: torch.nn.Module, kind: str = "GroupNormAct"):
        hooks = []

        def hook(mod, inputs, out):
            x = inputs[0]
            back = torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad
                                       for p in mod.parameters()))
            self.calls.append((tuple(x.shape), x.dtype, out.dtype, back))

        for model in models:
            for m in model.modules():
                if type(m).__name__ == kind:
                    hooks.append(m.register_forward_hook(hook))
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()

    def bytes(self, backward: bool = True) -> Dict[str, float]:
        """Bytes of rows 2-4 over the recorded calls: stats (row 2), apply
        (row 3), and, for calls whose gradient is taken, the backward's
        sums and dx (row 4)."""
        out = {"stats": 0.0, "apply": 0.0, "bwd_sums": 0.0, "bwd_dx": 0.0}
        for shape, xdt, ydt, back in self.calls:
            n = 1
            for s in shape:
                n *= s
            xb = n * torch.finfo(xdt).bits // 8
            yb = n * torch.finfo(ydt).bits // 8
            out["stats"] += xb
            out["apply"] += xb + yb
            if backward and back:
                out["bwd_sums"] += xb + yb       # x and dy (dy as y)
                out["bwd_dx"] += 2 * xb + yb     # x, dy read; dx written
        return out


def gpt_layer_weights(cfg) -> int:
    """Weights of one GPT block (`GPTConfig`): self-attention q and out
    (n_embed x heads*dim_head each) and its one K/V head (n_embed x
    dim_head), cross-attention q and out and K/V (n_cond_embed x
    dim_head), the 4x feed-forward; norms left out."""
    d, inner = cfg.n_embed, cfg.n_head * cfg.dim_head
    return (2 * d * inner + d * cfg.dim_head + 2 * d * inner
            + cfg.n_cond_embed * cfg.dim_head + 2 * d * 4 * d)


def token_step_counts(cfg, rows: int, pos: float, weight_bytes: int,
                      context: int = 77, cache_bytes: int = 2) -> Dict:
    """FLOPs and bytes of one token step of `rows` CFG rows at position
    `pos` through the GPT's blocks: the weights read once at
    `weight_bytes` each, the self-attention cache's pos + 1 rows read and
    one written, the cross-attention K/V (context plus the null) read, each
    at `cache_bytes`; FLOPs 2 a weight a row plus the attention products."""
    layers, dh = cfg.n_layer, cfg.dim_head
    w = layers * gpt_layer_weights(cfg)
    kv_rows = (pos + 1) + (context + 1)
    nbytes = (w * weight_bytes
              + layers * rows * (kv_rows + 1) * dh * cache_bytes)
    flops = 2 * rows * w + layers * rows * cfg.n_head * dh * 2 * 2 * kv_rows
    return {"flops": float(flops), "bytes": float(nbytes)}
