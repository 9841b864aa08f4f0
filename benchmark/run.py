"""Run one cell of the port's benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process: set-up (weights and inputs from the seed, the cell's shapes
warmed up), the measured window of `--seconds`, the check of what the
timed path produced against the plain reference (after the window, with
the port's state freed), then one JSON line, the last on standard output.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from host spans, the port's counters and a profiler
trace of the window's first `trace_seconds`. Never runs on the CPU: without
enough CUDA devices it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark.harness import (ROOT, Context, driver_module,  # noqa: E402
                               forbidden_modules, load_cell, metric_reader)
from benchmark.trace import Tracer  # noqa: E402

# the compile caches: fixed directories inside the checkout (nvcc's
# libraries go to build/favae_tpu_torch/, where the port's _build.py puts
# them); USE_FLAX keeps libraries that would load JAX from doing so
CACHE_ENV = {"TRITON_CACHE_DIR": str(ROOT / "build" / "triton"),
             "USE_FLAX": "0"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out = [f"nvidia-smi failed: {e}"]
    return {"name": name, "nvidia_smi": out[0] if out else ""}


def refuse_modules(when: str) -> bool:
    """True, with what was found on standard error, where the process
    holds a forbidden module (`harness.FORBIDDEN_MODULES`)."""
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the process holds {found} {when}",
              file=sys.stderr)
    return bool(found)


def main(argv=None) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    os.environ.update(CACHE_ENV)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    traffic = cell.traffic
    tracer = Tracer(traffic["trace_seconds"]) if args.trace else None
    workdir = Path(tempfile.gettempdir()) / "favae_bench" / cell.name
    ctx = Context(cell, args.seed, device, args.seconds, tracer, workdir)
    drv = driver_module(traffic["driver"])

    state = drv.setup(ctx)
    win = drv.window(state, ctx)
    setup_s = win.t0 - T_START
    peak = torch.cuda.max_memory_allocated(device)
    if refuse_modules("after the window"):
        return 3
    info = card(torch)
    checks = drv.check(state, ctx)
    correct = all(c.ok for c in checks)

    metrics = {}
    if not args.trace:
        have = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
                **win.metrics}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
    else:
        record = {"cell": cell, "window": win, "spans": ctx.spans.items,
                  "trace": tracer.summary, "traced_host": tracer.host,
                  "device": device, "ctx": ctx}
        for m in cell.per_layer():
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": info["name"], "count": chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win.work, "failed": 0,
              "metrics": metrics, "device": dev, "card": info,
              "window_s": win.seconds}
    if args.trace:
        s = tracer.summary
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(f"card: {info['nvidia_smi']}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    # the check and the readers import more: look again before the result
    if refuse_modules("before its result"):
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
