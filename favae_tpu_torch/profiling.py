"""Device time by kernel group from a `torch.profiler` run on the card.

Shared by `cli/profile_recon.py` and the trainer's profiler window: sums the
device time of every CUDA event by kernel name, folds the names into groups
and reports the busy share of the host-clock window.
"""

from __future__ import annotations

import collections
from typing import Dict

import torch

# kernel-name fragments -> group; the first match wins
_GROUPS = (
    ("vq_nearest (CUDA)", ("vq_argmax",)),
    ("group norm fwd (Triton)", ("_stats_kernel", "_apply_kernel")),
    ("group norm bwd (CUDA, Triton)", ("gn_bwd_sums", "_bwd_dx_kernel")),
    ("conv / matmul", ("conv", "gemm", "xmma", "cutlass", "sm90_", "cudnn",
                       "implicit", "nchwToNhwc", "nhwcToNchw", "wgrad",
                       "dgrad")),
    ("optimizer", ("adam", "Adam", "multi_tensor")),
    ("reduce", ("reduce",)),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "Memcpy",
                            "Memset", "cat", "index", "upsample", "pad",
                            "reflection")),
)


def kernel_group(name: str) -> str:
    for group, frags in _GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def summarize(prof: torch.profiler.profile, wall_ms: float, steps: int,
              top: int = 12) -> Dict:
    """Per-step device time by group and by kernel over a profiled window of
    `steps` steps that took `wall_ms` on the host clock."""
    by_kernel = collections.Counter()
    calls = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.device_time_total / 1e3 / steps
            calls[evt.name] += 1
    busy = sum(by_kernel.values())
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    groups = collections.Counter()
    for name, ms in by_kernel.items():
        groups[kernel_group(name)] += ms
    per_step = wall_ms / steps
    return {
        "steps": steps, "wall_ms_per_step": per_step,
        "device_busy_ms_per_step": busy, "device_busy_share": busy / per_step,
        "device_ops_per_step": sum(calls.values()) / steps,
        "groups_ms": dict(groups.most_common()),
        "top_kernels": [{"name": name[:160], "ms": ms,
                         "calls_per_step": calls[name] / steps}
                        for name, ms in by_kernel.most_common(top)],
    }
