"""Time two checkouts of favae_tpu_torch on one card, in turns.

    python -m favae_tpu_torch.cli.compare_turns OLD_DIR NEW_DIR
        [--parts serve train recon] [--out FILE]

Each turn is a fresh process whose working directory is one checkout (so it
builds and loads that checkout's kernels). The `serve` part:
`chip_smoke.serve_slice()` (`cli.generate` at cat_celebahq through its
engines, ms a token from CUDA events), `chip_smoke.check_decode_step()` (the
whole-step kernel at gpt2_medium, `device_ms` from a replayed CUDA graph)
and `matmul_int8` on seeded inputs at the four CAT projection shapes. The
`train` part: the first pass of the GroupNorm backward, from the per-channel
vectors to c2 and c3 (in a checkout before `csrc/gn_bwd_sums.cu`: p and q,
the Triton sums, their sum over chunks and `gn_bwd_fold`; after it: the
kernel and the sum over images), `device_ms` replayed in a CUDA graph at
every shape of a celebahq_expe5 train step's backward, weighted by its calls
a step; the device kernels of one whole backward call (torch.profiler); and
`cli.train_favae` with `chip_smoke.TRAIN_ARGS` (expe5, batch 16, 64 steps
without the discriminator and 64 with it), its steady step ms (median over
each epoch but its first two steps). The `recon` part: `cli.eval_favae`
with `chip_smoke.SLICE_ARGS` (expe5, batch 16, 64 images; its steady batch
ms) and the `recon` time of `chip_smoke.py` (CUDA events around 10 eager
`reconstruct` calls of a batch of 16, host included), three times. The
turns run OLD, NEW, NEW, OLD; the
script prints one JSON line a turn and a last line that says whether
`matmul_int8` gave the same bits in both checkouts (serve part), and writes
all of it to FILE (default output/turns.json).
"""

import argparse
import json
import pathlib
import subprocess
import sys

TURN = r'''
import inspect, json, statistics, sys, torch, numpy as np
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {"tree": sys.argv[1], "card": cs.nvidia_smi()}
parts = sys.argv[3].split(",")
bits = []
if "serve" in parts:
    from favae_tpu_torch.ops import int8_matmul as im
    runs, launches = cs.serve_slice()
    out["serve"] = {name: {k: r[k] for k in ("ms_per_token", "first_token_ms",
                                             "tokens_per_s", "launches")}
                    for name, r in runs.items()}
    step = cs.check_decode_step()
    out["decode_step"] = {k: step[k] for k in ("device_ms", "ms",
                                               "max_abs_err")}
    for i, (k, n) in enumerate([(1536, 1024), (1024, 1536), (1536, 6144),
                                (6144, 1536)]):
        rng = np.random.RandomState(20 + i)
        x = torch.from_numpy(rng.randn(8, k).astype(np.float32)).cuda()
        w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32))
        wq, scale = im.quantize_weight(w.cuda())
        bits.append(im.matmul_int8(x.bfloat16(), wq, scale).view(
            torch.int16).cpu())
if "train" in parts:
    from favae_tpu_torch.cli import train_favae
    from favae_tpu_torch.ops import gn
    # (N, C, H, W, act) of a train step's GroupNorm backward, calls a step
    census = [((16, 128, 256, 256, "silu"), 13), ((16, 128, 128, 128, "silu"), 9),
              ((16, 256, 128, 128, "silu"), 1), ((16, 256, 64, 64, "silu"), 9),
              ((16, 256, 32, 32, "silu"), 9), ((16, 512, 32, 32, "silu"), 1),
              ((16, 512, 16, 16, None), 7), ((16, 512, 16, 16, "silu"), 22),
              ((16, 256, 16, 16, "silu"), 3), ((16, 128, 64, 64, "silu"), 1)]
    old_api = "p" in inspect.signature(gn.gn_bwd_sums).parameters
    shapes, total = [], 0.0
    for (n, c, h, w, act), calls in census:
        g = torch.Generator(device="cuda").manual_seed(c + h)
        cl = torch.channels_last
        x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2
             + 0.5).bfloat16().contiguous(memory_format=cl)
        dy = torch.randn(n, c, h, w, device="cuda", generator=g).bfloat16(
            ).contiguous(memory_format=cl)
        scale = torch.randn(c, device="cuda", generator=g)
        bias = torch.randn(c, device="cuda", generator=g)
        a, b, mean, inv = gn.gn_affine(gn.gn_stats_plain(x), scale, bias, 32,
                                       h * w, 1e-5)
        if old_api:
            def first_pass():
                cg = c // 32
                p = inv.expand(-1, -1, cg).reshape(n, c)
                q = (-mean * inv).expand(-1, -1, cg).reshape(n, c)
                return gn.gn_bwd_fold(gn.gn_bwd_sums(x, dy, a, b, p, q, act),
                                      scale, mean, inv, h * w)
        else:
            def first_pass():
                return gn.gn_bwd_sums(x, dy, a, b, scale, mean, inv, act)
        ms = cs.device_ms(first_pass)
        total += ms * calls
        shapes.append({"shape": [n, c, h, w, act], "calls": calls,
                       "device_ms": ms})
    ins = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    y = gn.group_norm_act(*ins, 32, act=act)
    torch.autograd.grad(y, ins, dy, retain_graph=True)  # the stream's first
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
    out["gn_bwd_first_pass"] = {
        "weighted_device_ms_a_step": total, "shapes": shapes,
        "kernels_a_backward_call": sum(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())}
    hist = train_favae.main(cs.TRAIN_ARGS)["history"]
    for on in (False, True):
        ms = [h["step_ms"] for h in hist if h["disc_on"] == on][2:]
        out[f"step_ms_disc_{'on' if on else 'off'}"] = statistics.median(ms)
if "recon" in parts:
    from favae_tpu_torch.cli import eval_favae
    from favae_tpu_torch.config import celebahq_expe5
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    batch_ms = eval_favae.main(cs.SLICE_ARGS)["batch_ms"]
    model = build_model(celebahq_expe5(), "cuda", seed=0)
    ds = SyntheticDataset(256, size=16)
    x16 = torch.from_numpy(np.stack([ds.get(i) for i in range(16)])).cuda()
    with torch.inference_mode():
        recon = [cs.time_ms(lambda: model.reconstruct(x16), iters=10)
                 for _ in range(3)]
    out["recon"] = {"slice_steady_ms_per_batch": statistics.median(
        batch_ms[1:]), "recon_ms_per_batch": recon}
torch.save(bits, sys.argv[2])
print("TURN " + json.dumps(out), flush=True)
'''


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--parts", nargs="+", choices=("serve", "train", "recon"),
                    default=["serve", "train"])
    ap.add_argument("--out", default="output/turns.json")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    turns, bits = [], {}
    for i, (name, tree) in enumerate((("old", args.old), ("new", args.new),
                                      ("new", args.new), ("old", args.old))):
        path = out.with_name(f"{out.stem}_bits_{i}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", TURN, name, str(path),
             ",".join(args.parts)],
            cwd=pathlib.Path(tree).resolve(), capture_output=True, text=True)
        line = [l for l in proc.stdout.splitlines() if l.startswith("TURN ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({name}) failed")
        turns.append(json.loads(line[0][5:]))
        print(json.dumps(turns[-1]), flush=True)
        bits.setdefault(name, []).append(torch.load(path))
    same = (all(torch.equal(a, b) for a, b in zip(bits["old"][0],
                                                  bits["new"][0]))
            if "serve" in args.parts else None)
    result = {"turns": turns, "matmul_int8_same_bits": same}
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"matmul_int8_same_bits": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
