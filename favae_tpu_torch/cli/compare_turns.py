"""Time two checkouts of favae_tpu_torch on one card, in turns.

    python -m favae_tpu_torch.cli.compare_turns OLD_DIR NEW_DIR
        [--parts decode serve train recon] [--out FILE]

Each turn is a fresh process whose working directory is one checkout (so it
builds and loads that checkout's kernels). The `decode` part, first in the
process: the whole-step kernel at gpt2_medium, 8 rows, on seeded inputs
(`chip_smoke.check_decode_step`'s cross bias), 256 positions in order
given as ints, the bits of x and of the cache row at 0, 1, 128 and 255,
then `ms` and `device_ms` at pos 255 three times, the position given as
the checkout's token step gives it (a 0-dim device tensor where its kernel
reads one, `decode_pos`). The `serve` part:
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
`matmul_int8` (serve part) and the whole-step kernel (decode part) gave
the same bits in both checkouts, and writes all of it to FILE (default
output/turns.json).
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
bits = {"matmul_int8": [], "decode_step": []}
if "decode" in parts:
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops import decode_step_kernel as dk
    cfg = C.gpt2_medium(vocab_size=1024, n_cond_embed=768)
    torch.manual_seed(11)
    gpt = GPT(cfg).cuda().eval()
    rng = np.random.RandomState(11)
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    L, H, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    with torch.inference_mode():
        fused = dk.prepare_fused_decode(gpt, cfg)
        kv, xs = t(L, 8, 78, dh).bfloat16(), t(256, 8, d).bfloat16()
        rel = t(256, L, H, 257)
        rel[..., 0] = 0.0
        bias = torch.zeros(8, 78, device="cuda")
        bias[4:, 1:] = -1e9
        bias[0, 20:] = -1e9
        caches = torch.zeros(L, 8, 256, dh, dtype=torch.bfloat16,
                             device="cuda")
        for pos in range(256):
            args = (kv, bias, rel[pos].contiguous(), fused, cfg)
            x_new, _ = dk.decode_step_fused(xs[pos], pos, caches, *args)
            if pos in (0, 1, 128, 255):
                bits["decode_step"] += [
                    x_new.view(torch.int16).cpu(),
                    caches[:, :, pos].view(torch.int16).cpu()]
        # timed as the checkout's token step launches it: a tree whose
        # kernel reads the position from the device gets it there
        last = (torch.full((), 255, dtype=torch.long, device="cuda")
                if hasattr(dk, "check_positions") else 255)
        out["decode_pos"] = type(last).__name__
        step = lambda: dk.decode_step_fused(xs[255], last, caches, *args)
        out["decode"] = [{"ms": cs.time_ms(step, iters=50),
                          "device_ms": cs.device_ms(step, calls=20)}
                         for _ in range(3)]
    del gpt, fused
    torch.cuda.empty_cache()
if "serve" in parts:
    from favae_tpu_torch.ops import int8_matmul as im
    runs, launches = cs.serve_slice()
    out["serve"] = {name: {k: r.get(k) for k in (
        "ms_per_token", "median_ms_per_token", "first_token_ms",
        "tokens_per_s", "launches")} for name, r in runs.items()}
    step = cs.check_decode_step()
    out["decode_step"] = {k: step[k] for k in ("device_ms", "ms",
                                               "max_abs_err")}
    for i, (k, n) in enumerate([(1536, 1024), (1024, 1536), (1536, 6144),
                                (6144, 1536)]):
        rng = np.random.RandomState(20 + i)
        x = torch.from_numpy(rng.randn(8, k).astype(np.float32)).cuda()
        w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32))
        wq, scale = im.quantize_weight(w.cuda())
        bits["matmul_int8"].append(im.matmul_int8(x.bfloat16(), wq, scale).view(
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
    ap.add_argument("--parts", nargs="+",
                    choices=("decode", "serve", "train", "recon"),
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
    part = {"matmul_int8": "serve", "decode_step": "decode"}
    same = {f"{k}_same_bits": (
        all(torch.equal(a, b) for a, b in zip(bits["old"][0][k],
                                              bits["new"][0][k]))
        if part[k] in args.parts else None) for k in part}
    out.write_text(json.dumps({"turns": turns, **same}, indent=1))
    print(json.dumps(same))
    return 0


if __name__ == "__main__":
    sys.exit(main())
