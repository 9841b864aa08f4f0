"""Arithmetic shared by the per-layer metric readers (`metrics/*.py`).

A reader gets the run's record: the cell, the window (`harness.Window`),
the host spans, the trace's reduction (`trace.reduce_events`, or None in a
run without one), the traced host interval and, through `counts(record)`,
the driver's operation and byte counts of one work item. A reader that
finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark import roofline
from benchmark.harness import driver_module
from benchmark.trace import kernel_group

# the GroupNorm kernels, picked by their group in `trace.GROUPS`, where the
# first match wins (PyTorch's `multi_tensor_apply_kernel` of the optimizer
# also holds "_apply_kernel")
GN_GROUPS = ("group norm fwd (Triton)", "group norm bwd (CUDA, Triton)")


def window_spans(record, name: str):
    w = record["window"]
    return [(a, b) for n, a, b in record["spans"]
            if n == name and a >= w.t0 and b <= w.t1]


def mean_span_ms(record, name: str) -> Optional[float]:
    spans = window_spans(record, name)
    if not spans:
        return None
    return 1e3 * statistics.fmean(b - a for a, b in spans)


def traced_items(record) -> int:
    """Work items (the driver's work span) launched inside the trace."""
    lo, hi = record["traced_host"]
    name = record["window"].extra["work_span"]
    return sum(1 for n, a, b in record["spans"]
               if n == name and a >= lo and b <= hi)


def busy_ms_per_item(record) -> Optional[float]:
    t, n = record["trace"], traced_items(record)
    if t is None or n == 0:
        return None
    return 1e3 * t["busy_s"] / n


def idle_pct(record) -> Optional[float]:
    t = record["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def counts(record) -> dict:
    if "counts" not in record:
        cell = record["cell"]
        drv = driver_module(cell.traffic["driver"])
        record["counts"] = drv.counts(record["ctx"])
    return record["counts"]


def untraced_item_s(record) -> Optional[float]:
    """Host seconds a work item after the trace closed (the profiler's own
    cost left out): from the trace's end to the window's end over the items
    started in it."""
    w = record["window"]
    hi = record["ctx"].tracer.resumed if record["trace"] is not None \
        else w.t0
    name = w.extra["work_span"]
    n = sum(1 for s, a, b in record["spans"]
            if s == name and a >= hi and b <= w.t1)
    if n == 0:
        return None
    return (w.t1 - hi) / n


def mfu_pct(record, key: str, dtype: str = "bfloat16") -> Optional[float]:
    t = untraced_item_s(record)
    if t is None:
        return None
    return 100.0 * counts(record)[key] / (t * roofline.PEAK_FLOPS[dtype])


def gn_roofline_pct(record, key: str) -> Optional[float]:
    t, n = record["trace"], traced_items(record)
    if t is None or n == 0:
        return None
    dev = sum(s for k, s in t["kernel_s"].items()
              if kernel_group(k) in GN_GROUPS)
    if dev <= 0:
        return None
    nbytes = sum(counts(record)[key].values())
    return 100.0 * (nbytes / roofline.HBM_BYTES_PER_S) / (dev / n)


def median_token_s(record) -> Optional[float]:
    ms = [t for r in record["window"].extra.get("timings", [])
          for t in r["token_ms"][2:]]
    return statistics.median(ms) / 1e3 if ms else None
