"""What every cell shares: its files found by name, host spans, the
profiler's traced window, the comparison records and the result line.

A cell (`BENCHMARK.json` `workloads`) names a configuration and a traffic
mix. `configs/<config>.json` holds the configuration as it is run,
`traffic/<cell>.json` names the driver (`drivers/<driver>.py`) and its
parameters, and each per-layer metric is read by `metrics/<metric>.py`.
Nothing here names a cell, a configuration or a metric: a later cell comes
as files of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# what the process that prints a result may not hold once the window has
# closed, compared by whole top-level module names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "favae_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]          # the `workloads` entry
    config: Dict[str, Any]         # configs/<config>.json
    traffic: Dict[str, Any]        # traffic/<cell>.json
    bench: Dict[str, Any]          # BENCHMARK.json

    def _mine(self, metrics: List[Dict]) -> List[Dict]:
        return [m for m in metrics
                if "workloads" not in m or self.name in m["workloads"]]

    def end_to_end(self) -> List[Dict]:
        return self._mine(self.bench["end_to_end"])

    def per_layer(self) -> List[Dict]:
        return self._mine(self.bench["per_layer"])


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}: "
                         f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, config, traffic, bench)


def driver_module(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """`read(record)` of metrics/<name>.py (the file name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host spans of the benchmark's own calls into the port: (name, start,
    end) on `time.perf_counter`. While a trace is open each span is also a
    `record_function` range named `bench:<name>`, so that the trace's idle
    gaps can be labelled by what the host was doing."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.annotate:
            import torch
            rf = torch.profiler.record_function("bench:" + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t0, t1))


@dataclasses.dataclass
class Check:
    """One number compared with its limit; `ok` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a driver's measured window did: host start and end, the work
    items completed in it (steps or requests), the end-to-end metrics it
    computed, and anything its metric readers need (`extra`)."""
    t0: float
    t1: float
    work: int
    metrics: Dict[str, float]
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Context:
    """What a driver gets: the cell, the seed, the device, the window's
    length, the spans, the tracer (or None) and a scratch directory."""

    def __init__(self, cell: Cell, seed: int, device, seconds: float,
                 tracer=None, workdir: Optional[Path] = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.seconds = seconds
        self.spans = Spans()
        self.tracer = tracer
        self.workdir = workdir
        self.deadline = float("inf")

    def open_window(self) -> float:
        """Start the measured window: the deadline is set, and a trace, if
        asked for, opens."""
        t0 = time.perf_counter()
        self.deadline = t0 + self.seconds
        if self.tracer is not None:
            self.tracer.start(self.spans)
        return t0

    def tick(self) -> None:
        """Called by a driver between work items: closes the trace once
        its time is up. The trace's reduction is not work of the window:
        the deadline moves by the time it took."""
        if self.tracer is not None and self.tracer.prof is not None:
            t = time.perf_counter()
            self.tracer.maybe_stop()
            if self.tracer.prof is None:
                self.deadline += time.perf_counter() - t

    def close_window(self) -> float:
        if self.tracer is not None:
            self.tracer.stop()
        return time.perf_counter()

    @property
    def due(self) -> bool:
        return time.perf_counter() >= self.deadline


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})
