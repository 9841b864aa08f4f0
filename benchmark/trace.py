"""The traced run's device timeline: `torch.profiler` over the first
`trace_seconds` of the window (a traffic parameter), reduced to the busy
time (the union of the device's operation intervals, not their sum), the
idle gaps labelled by the benchmark's host span open when each began, the
device time by kernel name and group, and the device operations that took
most time.

`GROUPS` is copied from the port's `favae_tpu_torch/profiling.py::_GROUPS`
(kernel-name fragments -> group; the first match wins); the arithmetic
around it is this file's own.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

GROUPS = (
    ("vq_nearest (CUDA)", ("vq_argmax",)),
    ("optimizer", ("adam", "Adam", "multi_tensor")),
    ("group norm fwd (Triton)", ("_stats_kernel", "_apply_kernel")),
    ("group norm bwd (CUDA, Triton)", ("gn_bwd_sums", "_bwd_dx_kernel")),
    ("conv / matmul", ("conv", "gemm", "xmma", "cutlass", "sm90_", "cudnn",
                       "implicit", "nchwToNhwc", "nhwcToNchw", "wgrad",
                       "dgrad", "nvjet")),
    ("layer norm", ("layer_norm", "GammaBeta")),
    ("reduce", ("reduce",)),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "Memcpy",
                            "Memset", "cat", "index", "upsample", "pad",
                            "reflection")),
)


def kernel_group(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def union(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, merged intervals) of intervals clipped to [lo, hi]."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def gaps(merged: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def label_at(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost span (latest started) open at time t, else "host"."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "host"


def reduce_events(kernels: List[Tuple[str, float, float]],
                  spans: List[Tuple[str, float, float]],
                  lo: float, hi: float, top: int = 10) -> Dict:
    """Kernels (name, start, end) and bench spans (name, start, end), all in
    seconds on one clock, over the window [lo, hi]."""
    busy, merged = union([(a, b) for _, a, b in kernels], lo, hi)
    by_name = collections.Counter()
    calls = collections.Counter()
    for name, a, b in kernels:
        by_name[name] += b - a
        calls[name] += 1
    by_group = collections.Counter()
    for name, s in by_name.items():
        by_group[kernel_group(name)] += s
    idle = collections.defaultdict(list)
    for a, b in gaps(merged, lo, hi):
        idle[label_at(spans, a)].append(b - a)
    idle_rows = sorted(((k, sum(v), len(v), max(v)) for k, v in idle.items()),
                       key=lambda r: -r[1])
    return {
        "window_s": hi - lo, "busy_s": busy,
        "kernel_s": dict(by_name), "kernel_calls": dict(calls),
        "group_s": dict(by_group),
        "device_ops": [[f"{kernel_group(n)}: {n[:150]}", s]
                       for n, s in by_name.most_common(top)],
        "idle_gaps": [[f"{k} ({n} gaps, longest {m!r} s)", s]
                      for k, s, n, m in idle_rows[:top]],
    }


class Tracer:
    """`torch.profiler` (host and device) from the window's start until
    `seconds` have passed at a work item's boundary (`maybe_stop`), or the
    window's end. Synchronises at both ends, so the traced device work is
    exactly the work launched inside."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.summary: Optional[Dict] = None
        self.host = (0.0, 0.0)

    def start(self, spans) -> None:
        import torch
        torch.cuda.synchronize()
        self.spans = spans
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark = torch.profiler.record_function("bench:traced")
        self._mark.__enter__()
        spans.annotate = True
        self.t0 = time.perf_counter()

    def maybe_stop(self) -> None:
        if self.prof is not None and \
                time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.spans.annotate = False
        self.host = (self.t0, time.perf_counter())
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.summary = self._reduce(prof)
        self.resumed = time.perf_counter()

    @staticmethod
    def _reduce(prof) -> Dict:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        kernels, spans, window = [], [], None
        for e in prof.events():
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == cuda:
                if not e.name.startswith("bench:"):  # a span's device range
                    kernels.append((e.name, a, b))
            elif e.name == "bench:traced":
                window = (a, b)
            elif e.name.startswith("bench:"):
                spans.append((e.name[len("bench:"):], a, b))
        if window is None:
            raise RuntimeError("the trace lost its window mark")
        if not kernels:
            raise RuntimeError("the profiler saw no device operation")
        return reduce_events(kernels, spans, *window)
