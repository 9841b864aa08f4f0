"""Where the time of one reconstruction batch goes on the card.

    python -m favae_tpu_torch.cli.profile_recon [--steps 5] [--trace FILE]

Builds a celebahq_expe5 model with seeded random weights, warms it up, then
runs `--steps` reconstructions of one batch of 16 synthetic 256 px images
under `torch.profiler` and prints one JSON line: the wall time a batch takes
(host clock around synchronised steps), the device's busy time and busy
share over that window, device time by kernel group, the costliest kernels
with their calls, and how many device operations (kernels, copies) a batch
runs. `--trace` also writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

BATCH, RESOLUTION = 16, 256  # eval_favae's default batch, expe5's images


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None, help="Chrome trace output path")
    args = p.parse_args(argv)

    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.config import celebahq_expe5
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    from favae_tpu_torch.profiling import summarize

    device = resolve_device("cuda")
    model = build_model(celebahq_expe5(), device)
    ds = SyntheticDataset(RESOLUTION, size=BATCH)
    x = torch.from_numpy(np.stack([ds.get(i) for i in range(BATCH)]))
    x = x.to(device)
    for _ in range(3):
        model.reconstruct(x)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model.reconstruct(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    out = {"device": torch.cuda.get_device_name(0),
           "preset": "celebahq_expe5", "batch_size": BATCH,
           "resolution": RESOLUTION, **summarize(prof, wall_ms, args.steps)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
