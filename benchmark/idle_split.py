"""The traced window's device idle time split by cause, and a traced run
that reports it.

    python -m benchmark.idle_split --workload <cell> --seed <n> --seconds <s>

runs the cell as `python -m benchmark.run ... --trace 1` does (`--trace`
is taken and ignored), with `SplitTracer` in the place of `trace.Tracer`
(the same profiler over the same window, the same result line), then
prints one more JSON line: the split a traced work item and the traced
window's host time a work item. The benchmark's own runs never run this.

The split (`split_idle`): for each idle gap [a, b) of the device, the
operation that starts at b was launched by the runtime or driver call with
its correlation id, at host time L. [a, min(L, b)) is starved: the host had
not launched the work yet. It is split over time by the innermost span
open on the launching thread, a program span (`favae:`, the port's
`profiling.span`) before a benchmark span (`bench:`), else `host`. The
rest of the gap is queued: the work was launched and the device had yet to
start it, as between a graph's kernels. A gap whose next operation has no
launch call, or that runs to the window's end, is starved under `host`
and counted in `unlaunched`.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import sys
from typing import Dict, List, Optional, Tuple

from benchmark import trace
from benchmark.metrics_common import traced_items

# runtime and driver calls by name, where the profiler's events do not say
# their kind: cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync,
# cuLaunchKernel (Triton), ...
_CALL = re.compile(r"^cu(da)?[A-Z]")

Span = Tuple[str, float, float, bool]  # name, start, end, program span


class Labels:
    """One thread's time cut where its spans open and close, each stretch
    labelled by the innermost (latest started) program span open in it,
    else the innermost benchmark span, else "host"."""

    def __init__(self, spans: List[Span]):
        self.cuts = sorted({t for _, a, b, _ in spans for t in (a, b)})
        self.labels = []
        for x, y in zip(self.cuts, self.cuts[1:]):
            mid, best = (x + y) / 2, {}
            for name, a, b, program in spans:
                if a <= mid < b and (program not in best
                                     or a >= best[program][0]):
                    best[program] = (a, name)
            pick = best.get(True) or best.get(False)
            self.labels.append(pick[1] if pick else "host")

    def add(self, a: float, b: float, into: Dict[str, float]) -> None:
        """[a, b)'s seconds into `into`, by label."""
        i = bisect.bisect_right(self.cuts, a) - 1
        while a < b:
            if 0 <= i < len(self.labels):
                label, end = self.labels[i], self.cuts[i + 1]
            else:
                label = "host"
                end = self.cuts[0] if i < 0 and self.cuts else b
            end = min(end, b)
            into[label] += end - a
            a, i = end, i + 1


def split_idle(ops: List[Tuple[float, float, int]],
               launches: Dict[int, Tuple[float, int]],
               spans: Dict[int, List[Span]], lo: float, hi: float) -> Dict:
    """Device operations (start, end, correlation id), launch calls
    (correlation id -> (host time, thread)) and host spans by thread, all
    in seconds on one clock, over the window [lo, hi]: the idle time's
    parts (module docstring)."""
    _, merged = trace.union([(a, b) for a, b, _ in ops], lo, hi)
    launched_at: Dict[float, Tuple[float, int]] = {}
    for a, _, corr in ops:  # the earliest launch among ops starting at a
        if corr in launches and (a not in launched_at
                                 or launches[corr] < launched_at[a]):
            launched_at[a] = launches[corr]
    labels = {tid: Labels(s) for tid, s in spans.items()}
    starved: Dict[str, float] = collections.defaultdict(float)
    queued, idle, n, unlaunched = 0.0, 0.0, 0, 0
    for a, b in trace.gaps(merged, lo, hi):
        n, idle = n + 1, idle + (b - a)
        if b >= hi or b not in launched_at:
            starved["host"] += b - a
            unlaunched += 1
            continue
        at, tid = launched_at[b]
        cut = min(max(at, a), b)
        if cut > a:
            if tid in labels:
                labels[tid].add(a, cut, starved)
            else:
                starved["host"] += cut - a
        queued += b - cut
    return {"window_s": hi - lo, "idle_s": idle, "queued_s": queued,
            "starved_s": dict(sorted(starved.items(), key=lambda r: -r[1])),
            "gaps": n, "unlaunched": unlaunched}


def _is_call(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return bool(_CALL.match(e.name()))


def timeline(prof):
    """(ops, launches, spans by thread, window) from a finished profiler's
    raw (Kineto) events: the device operations but the spans' device-side
    ranges, the launch calls, and the `favae:` and `bench:` host ranges
    but the window's own mark."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches, window = [], {}, None
    spans: Dict[int, List[Span]] = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e9
        b = a + e.duration_ns() / 1e9
        annotation = name.startswith(("bench:", "favae:"))
        if e.device_type() == cuda:
            if not (annotation or e.is_user_annotation()):
                ops.append((a, b, e.correlation_id()))
        elif name == "bench:traced":
            window = (a, b)
        elif annotation:
            spans[e.start_thread_id()].append(
                (name[len("favae:"):], a, b, name.startswith("favae:")))
        elif _is_call(e):
            launches[e.correlation_id()] = (a, e.start_thread_id())
    if window is None:
        raise RuntimeError("the trace lost its window mark")
    return ops, launches, dict(spans), window


class SplitTracer(trace.Tracer):
    """`trace.Tracer` whose reduction also holds `idle_split`
    (`split_idle` over the same events)."""

    @staticmethod
    def _reduce(prof) -> Dict:
        summary = trace.Tracer._reduce(prof)
        ops, launches, spans, window = timeline(prof)
        summary["idle_split"] = split_idle(ops, launches, spans, *window)
        return summary


def report(record) -> Dict:
    """The split's parts a traced work item, by the names the per-layer
    metrics would take, from a traced run's record (`run.main`'s, with
    `SplitTracer`'s summary); `item_host_ms` is the traced window's host
    time a work item."""
    t, n = record["trace"], traced_items(record)
    s, part = t["idle_split"], t["idle_split"]["starved_s"]
    lo, hi = record["traced_host"]

    def ms(prefixes) -> Optional[float]:
        if n == 0:
            return None
        return 1e3 * sum(v for k, v in part.items()
                         if k.startswith(prefixes)) / n

    return {"traced_items": n,
            "item_host_ms": 1e3 * (hi - lo) / n if n else None,
            "idle_pct": 100.0 * s["idle_s"] / s["window_s"],
            "idle_queued": 100.0 * s["queued_s"] / s["window_s"],
            "idle_data_ms": ms(("data.",)),
            "idle_codec_ms": ms(("codec.",)),
            "idle_setup_ms": ms(("graphs.first", "graphs.capture")),
            # starved under no program span: a benchmark span or none
            "idle_unspanned_ms": ms(tuple(k for k in part if "." not in k)),
            "device_idle_pct": 100.0 * (1 - t["busy_s"] / t["window_s"])}


def main(argv=None) -> int:
    """`run.main` with `SplitTracer`, its record kept as the first
    per-layer reader gets it; then the split's line."""
    from benchmark import run
    args = run.parse(argv)
    records: List[Dict] = []
    read = run.metric_reader

    def keeping(name):
        def reader(record):
            records[:] = [record]
            return read(name)(record)
        return reader

    run.Tracer, run.metric_reader = SplitTracer, keeping
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not records:
        return rc or 1
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **report(records[0]),
                      "idle_split": records[0]["trace"]["idle_split"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
