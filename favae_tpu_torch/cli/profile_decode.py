"""Where a token's time goes inside the whole-decode-step kernel.

Runs `decode_step_fused` on the card at a GPT preset's full width and depth
with seeded random weights and prints one JSON line: the kernel's time at a
few positions (CUDA events) and, from the timestamps block 0 writes after
each grid barrier, the mean time of each of a layer's phases
(`ops.decode_step_kernel.PHASES`, one grid barrier after each), split into
the work (until the last block reached the barrier) and the barrier.

    python -m favae_tpu_torch.cli.profile_decode [--gpt_name gpt2_medium]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpt_name", default="gpt2_medium",
                   choices=["gpt2_mini", "gpt2_medium"])
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--m_cross", type=int, default=78)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    from favae_tpu_torch import config as C
    from favae_tpu_torch import resolve_device
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops import decode_step_kernel as dk

    dev = resolve_device("cuda")
    cfg = getattr(C, args.gpt_name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpt = GPT(cfg).to(dev).eval()
    n_layer, heads, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    seq, rows = cfg.image_encoded_dim ** 2, args.rows
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    with torch.inference_mode():
        fused = dk.prepare_fused_decode(gpt, cfg)
        x = t(rows, d).bfloat16()
        caches = t(n_layer, rows, seq, dh).bfloat16()
        cross_kv = t(n_layer, rows, args.m_cross, dh).bfloat16()
        cross_bias = torch.zeros(rows, args.m_cross, device=dev)
        cross_bias[rows // 2:, 1:] = -1e9
        rel_rows = t(n_layer, heads, seq + 1)
        n = 1 + len(dk.PHASES) * n_layer
        clock = torch.zeros(2 * n, dtype=torch.int64, device=dev)
        out = {"gpt_name": args.gpt_name, "rows": rows,
               "phases": list(dk.PHASES), "positions": {}}
        for pos in (0, seq // 2, seq - 1):
            def step(phase_clock=None):
                dk.decode_step_fused(x, pos, caches, cross_kv, cross_bias,
                                     rel_rows, fused, cfg, phase_clock)
            for _ in range(3):
                step()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                step()
            end.record()
            torch.cuda.synchronize()
            phases = np.zeros(len(dk.PHASES))
            work = np.zeros(len(dk.PHASES))
            for _ in range(args.iters):
                clock.zero_()
                step(clock)
                ns = clock.cpu().numpy().astype(np.float64)
                passed, reached = ns[:n], ns[n:]
                # a time after the set-up's barrier and after each phase,
                # the last phase's without a barrier
                out["grid_barriers_per_layer"] = int(
                    (passed != 0).sum() - 1) // n_layer
                phases += np.diff(passed).reshape(n_layer, -1).sum(axis=0)
                work += (reached[1:] - passed[:-1]).reshape(
                    n_layer, -1).sum(axis=0)
            per_layer = lambda v: {name: us for name, us in zip(
                dk.PHASES, v / args.iters / n_layer / 1e3)}
            out["positions"][pos] = {
                "kernel_ms": start.elapsed_time(end) / args.iters,
                "phase_us_per_layer": per_layer(phases),
                "work_us_per_layer": per_layer(work),
                "barrier_us_per_layer": per_layer(phases - work),
                "phases_ms_per_token": float(phases.sum() / args.iters / 1e6)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
