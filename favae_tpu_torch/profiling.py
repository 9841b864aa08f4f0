"""The port's spans and counters, and device time by kernel group from a
`torch.profiler` run on the card.

`span(name)` marks a stretch of host work (the loader's wait, the codec's
stages, the token loop's set-up and replays) as a `favae:<name>` range on a
running profiler's clock; with none running it costs a flag check.
`counters()` is one flat snapshot of every counter the port keeps.

`summarize`, shared by `cli/profile_recon.py` and the trainers' profiler
window (`ProfileWindow`), sums the device time of every CUDA event by
kernel name, folds the names into groups and reports the busy share of the
host-clock window. `StepClock` times the trainers' steps.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range `favae:<name>` while a `torch.profiler` runs, nested in
    the ranges open around it; with no profiler running, one shared no-op
    context. The range is recorded at operator scope (`_RecordFunctionFast`)
    and not as a user annotation (`record_function`), which the profiler
    would also draw on the device's track across the kernels it encloses,
    where a trace reader counts it as busy time. Never open one inside a
    body captured into a CUDA graph: a replay does not run it."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast("favae:" + name)


def counters() -> Dict[str, float]:
    """Every counter the port keeps, as `{"group.name": number}`:
    `launches.<kernel>` (the kernel modules' `LAUNCHES`) and the work
    beside them (`graphs.work_counts`: `vq.macs`, `decode_step.bytes`,
    `rows_gemm.bytes`, `ffn_int8.bytes`, `codec.attn_calls`,
    `codec.attn_scores`), exact across graph replays;
    `collectives.*` (`parallel.mesh.STATS`), `data.*`
    (`data.pipeline.STATS`), `graphs.*` (`graphs.STATS`) and `serving.*`
    (`models.serving_plan.STATS`: plans built, hits, plans dropped). The
    counters are plain module dicts, always on: subtract two snapshots."""
    from favae_tpu_torch import graphs
    from favae_tpu_torch.data import pipeline
    from favae_tpu_torch.models import serving_plan
    from favae_tpu_torch.parallel import mesh
    out: Dict[str, float] = {}
    for launches in graphs.launch_counts():
        out.update((f"launches.{k}", v) for k, v in launches.items())
    for group, stats in (*graphs.work_counts().items(),
                         ("collectives", mesh.STATS),
                         ("data", pipeline.STATS), ("graphs", graphs.STATS),
                         ("serving", serving_plan.STATS)):
        out.update((f"{group}.{k}", v) for k, v in stats.items())
    return out


# kernel-name fragments -> group; the first match wins (the optimizer's
# `multi_tensor_apply_kernel` before the GroupNorm's `_apply_kernel`)
_GROUPS = (
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


class StepClock:
    """Start times of steps: CUDA events on the card, host clock else."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class ProfileWindow:
    """`torch.profiler` over steps [2, 5) of an epoch (`STEPS`): `at_step`
    before each step opens and closes the window, `close` after the epoch
    closes one the epoch was too short to close. Writes the Chrome trace
    to `save_dir` and, on the card, `summary` (`summarize`) to
    `profile_summary.json` beside it."""

    STEPS = (2, 5)

    def __init__(self, device: torch.device, save_dir: str):
        self.device, self.save_dir = device, save_dir
        self.prof: Optional[torch.profiler.profile] = None
        self.summary: Optional[Dict] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def at_step(self, step: int) -> None:
        if step == self.STEPS[0]:
            self._sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == self.STEPS[1]:
            self.close(step)

    def close(self, steps_done: int) -> None:
        if self.prof is None:
            return
        self._sync()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.save_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.save_dir,
                                              "profile_trace.json"))
        if self.device.type != "cuda":
            return
        self.summary = summarize(prof, wall_ms, steps_done - self.STEPS[0])
        self.summary["device"] = torch.cuda.get_device_name(0)
        with open(os.path.join(self.save_dir, "profile_summary.json"),
                  "w") as f:
            json.dump(self.summary, f, indent=1)
        print("profile " + json.dumps(self.summary), flush=True)
