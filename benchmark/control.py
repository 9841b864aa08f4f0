"""The readings that a cell's limits are set from, at the cell's own size
on the card: the control (the reference put in the program's place at the
precision below the configuration's) and the planted faults, each compared
with the reference as a run compares the program. One JSON line a seed.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

The benchmark's own runs never run this (see README.md)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

from benchmark.harness import Context, driver_module, load_cell
from benchmark.run import CACHE_ENV


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    os.environ.update(CACHE_ENV)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    drv = driver_module(cell.traffic["driver"])
    workdir = Path(tempfile.gettempdir()) / "favae_bench" / cell.name
    for seed in args.seeds:
        ctx = Context(cell, seed, torch.device("cuda:0"), 0.0, None, workdir)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          **drv.control(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
