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
import collections
import json
import time

import numpy as np
import torch

BATCH, RESOLUTION = 16, 256  # eval_favae's default batch, expe5's images

# kernel-name fragments -> group; the first match wins
_GROUPS = (
    ("vq_nearest (CUDA)", ("vq_argmax",)),
    ("group norm (Triton)", ("_stats_kernel", "_apply_kernel")),
    ("conv / matmul", ("conv", "gemm", "xmma", "cutlass", "sm90_", "cudnn",
                       "implicit", "nchwToNhwc", "nhwcToNchw")),
    ("reduce", ("reduce",)),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "Memcpy",
                            "Memset", "cat", "index", "upsample")),
)


def _group(name: str) -> str:
    for group, frags in _GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None, help="Chrome trace output path")
    args = p.parse_args(argv)

    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.config import celebahq_expe5
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model

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
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_kernel = collections.Counter()
    calls = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.device_time_total / 1e3 / args.steps
            calls[evt.name] += 1
    busy = sum(by_kernel.values())
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    groups = collections.Counter()
    for name, ms in by_kernel.items():
        groups[_group(name)] += ms
    out = {
        "device": torch.cuda.get_device_name(0),
        "preset": "celebahq_expe5", "batch_size": BATCH,
        "resolution": RESOLUTION, "steps": args.steps,
        "wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy,
        "device_busy_share": busy / wall_ms,
        "device_ops_per_batch": sum(calls.values()) / args.steps,
        "groups_ms": dict(groups.most_common()),
        "top_kernels": [{"name": name[:160], "ms": ms,
                         "calls_per_batch": calls[name] / args.steps}
                        for name, ms in by_kernel.most_common(12)],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
