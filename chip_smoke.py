"""Drive favae_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. device: print `nvidia-smi` name and power limit; fail without CUDA;
2. build: compile the CUDA kernels from this checkout's `csrc/` (timed);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the shapes celebahq_expe5 gives it, timed beside its bound
   and a one-call PyTorch yardstick, three ways: `ms` (CUDA events around
   eager wrapper calls, the host included), `device_ms` (the calls replayed
   in a CUDA graph; `launch_floor_ms`, an empty launch replayed the same
   way, is its floor) and, for the int8 kernels, `cold_ms` (a graph cycling
   through 128 MB of distinct weight copies, so nothing is found in L2);
   `vq_nearest` also with duplicated codes (exact ties go to the lowest
   index), `matmul_int8` also at M 16 and M 2: the forward kernels at the
   reconstruction's shapes, the GroupNorm backward kernels at every shape a
   train step's backward gives them (a census of one step with the
   discriminator and one without); the three int8 kernels of CAT serving
   at the shapes `cat_celebahq` gives them (`matmul_int8` at the four
   projection shapes; `ffn_block_int8` at both widths and 2, 6, 8 and 16
   rows, one launch a call, the same bits twice, over 100 replays of a
   graph of the call and on two streams at once, its work plan held
   against the Python copy; `decode_step_fused` at gpt2_medium's full width
   and depth over 256 positions, with the position an int and a device
   scalar (the same bits), a position outside the cache counted in the
   error word, raised and nothing written, and the 256 steps replayed from
   one captured step against the same step called eagerly, bit for bit);
   `ln_fused`'s kernel (row 8) against its plain op sequence in every form
   at gpt2_medium's two widths in bf16 and f32, timed at the token step's
   attention boundary (8 x 1536) and feed-forward middle (8 x 6144) beside
   the plain sequence eager and graphed; `mqa_decode`'s kernel (row 9)
   against its plain op sequence in both forms at gpt2_medium's attention
   (8 rows, 16 heads, a 256-row cache at positions 0, 128 and 255, 77 + 1
   text keys) and 24 heads, timed at position 255 beside its bytes' bound
   and the plain sequence eager and graphed; `rows_gemm`'s kernel (row 10)
   against its plain version at every product of gpt2_medium's and
   gpt2_large's token step at 2, 8, 9 and 16 rows, timed at 8 and 16 rows
   hot and cold, beside its bytes' bound and cuBLAS graphed, and every
   plan's shared memory as the kernel's library counts it;
4. recon slice: `favae_tpu_torch.cli.eval_favae` at celebahq_expe5, batch
   16, 256 px, bf16, seeded random weights, with the kernels' launch counts
   zeroed just before and read just after;
5. train slice: `favae_tpu_torch.cli.train_favae` at celebahq_expe5, batch
   16, 256 px, bf16, two epochs of 32 synthetic batches (the discriminator
   from the second) plus validation, saving `latest` and `best` after each
   epoch, then `--resume --epochs 3` for the third, counts zeroed just
   before each run and read just after and held to what the census
   implies; each checkpoint timed, read back onto the card and compared
   with the state it saved, bit for bit; then `cli.export_torch` of
   `best` and `cli.eval_favae` on the `.pt` with rFID (a seeded
   pytorch-fid-layout Inception file) and 64 saved reconstructions, and on
   the checkpoint directory without Inception (the same psnr);
6. cross-checks: the same weights reconstructing 2 images, and taking one
   train step on 2 images at 64 px, on the card (bf16, and f32 with TF32
   off) and on the CPU in f32 through the plain versions; two epochs of 4
   steps at 64 px, B=2, f32, against one epoch, a checkpoint, a resume and
   the second (TRAIN_XCHECK's bounds, and whether the bits matched); the
   InceptionV3 features of 2 images at 256 px on the card (f32 and bf16)
   against the CPU (f32);
7. serve slice: `favae_tpu_torch.cli.generate` at cat_celebahq, 2 prompts x
   2 images, seeded random weights, through its three engines (exact bf16
   through `GPT.sample`, `--quantized` on the whole-step kernel,
   `--quantized --gpt_name gpt2_large` on the int8 FFN kernel; every token
   step runs as a CUDA graph with launches counted per replay), counts
   zeroed before and read after each, ms a token beside the card's name
   and power limit (the exact runs 1 + 4 a layer `add_ln` launches and 2 a
   layer `mqa_decode` launches and 7 a layer `rows_gemm` launches a token,
   5 a layer on the FFN-only route); `GPT.sample` at gpt2_medium
   through the graph, one seed twice and another once, and the fused
   route replayed against the
   same step called eagerly (the same tokens and logits, bit for bit);
   `sample_tokens` at gpt2_large through the graph on its exact route (the
   FFN-only route's yardstick) and its FFN-only route, one seed twice and
   another once; `GPT.sample` at gpt2_medium with the token step's
   products through `rows_gemm` and through cuBLAS, in turns, and whether
   a captured
   graph of two launches holds a programmatic edge; then the same weights,
   text embeddings and gumbel noise
   through each engine on the card and on the CPU at 2 layers;
8. CAT train slice: `favae_tpu_torch.cli.train_cat` at cat_celebahq
   (gpt2_medium, CLIP ViT-L/14 text, f16 cosine FA-VAE), batch 16, 256 px,
   synthetic captions, seeded random weights, one short epoch on the full
   pipeline (the frozen encode, rows 1-3, in every step), saving, with a
   sample preview at global step 0 and after validation (an FA-VAE decode
   each, timed), a second epoch resumed from `latest`, `cli.export_torch --cat`
   of `best` and `cli.generate` on the `.pt` and on the directory (the
   same tokens), and one epoch with `--cache_latents` (the encode once,
   before the steps), counts zeroed just before each run and held to the
   encodes and previews each run makes; then one step at gpt2_medium
   width and 2 layers, B=2, f32, from one state on the card and on the CPU;
9. presets and options: `cli.train_favae` at ffhq_table1, imagenet_f16
   and imagenet_f4 as published (batch 16, or the largest of 8 and 4 that
   fits, 256 px, bf16, two epochs of 4 synthetic steps, the
   discriminator from the second, 4 val batches each), option run A at
   imagenet_f4's widths by flags (k-means init, dead-code expiry, the
   orthogonal regulariser on 1024 codes, bf16 Adam moments, uint8 PNGs
   of a manifest written here, decoded by worker processes; then a third
   epoch resumed) and B at imagenet_f16's (a 2-layer ActNorm PatchGAN, D
   from step 0, each ActNorm's init held to its input's statistics), each
   run zeroed before, read after and held to a census of its own config
   (steps with and without D, validation, the first-batch inits), every
   checkpoint read back and compared; k-means through `vq_nearest`
   against its plain version (cosine at A's first batch, euclidean at
   4096 x 1024 x 256); one train step of each config on the card against
   the CPU (A's with its quantizer draws given); `vq_nearest` at each
   preset's shape and the GroupNorm kernels at every new shape;
10. distribution: each run a `torch.distributed.run` subprocess of this
   script (`--rank-jobs`), killed at a timeout; every rank reads its own
   launch counts, held to its run's census: (a), (b) `cli.train_favae`
   (expe5, B=16, 4 steps) and `cli.train_cat` (cat_celebahq, B=16, 4
   steps) at world 1 over NCCL, bit for bit against the same runs here
   without a group; (c), (d) two ranks on the one card over gloo, the
   FA-VAE step data parallel (f32 64 px against one process on the same
   global batches; bf16 256 px) and `cli.train_cat --tp 2` (2 layers in
   f32 against `--tp 1`, its checkpoint resumed at tp=1 bit for bit; full
   depth in bf16), every rank ending with the same state; (e) NCCL with a
   card a rank on a machine with two, and NCCL's answer to two ranks on
   one card; then the CLIP vision towers (ViT-L/14, RN50) against the
   CPU.
It prints each phase's seconds, a `{"kernels": [...]}` line, the card's
name and power limit, and last `{"ok": true, "device": {...}}`. TF32 is
off for matmuls and cuDNN.
"""

import dataclasses
import gc
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, at the 700 W limit
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 in the tensor cores, dense
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 in the tensor cores, dense
COLD_BYTES = 128 << 20      # weights a cold timing cycles through (L2: 50 MB)
VQ_NEAR_TIE = 1e-5          # a chosen code may trail the best score by this
SLICE_ARGS = ["--preset", "celebahq_expe5", "--synthetic_data",
              "--batch_size", "16", "--max_images", "64"]
TRAIN_ARGS = ["--ds", "chip_smoke", "--output_dir", str(ROOT / "output"),
              "--preset", "celebahq_expe5", "--synthetic_data",
              "--batch_size", "16", "--epochs", "2", "--disc_start_epochs", "1",
              "--synthetic_steps", "32", "--print_steps", "16"]
# train cross-check bounds, f32 on the card against f32 on the CPU: loss
# terms and weight_d relative; codebook EMA and BatchNorm running statistics
# relative to each tensor's largest entry (the stage-1 recompute updates
# both through the stepped generator, whose parameters already differ by
# Adam's sign flips: 1.05e-4 measured on the codebook on an H100); the
# parameters in units of the learning rate (Adam's first step
# moves each parameter by about lr * sign(g), and one f32 ulp of a unit
# parameter is 0.03 lr at lr 4e-6); bf16 on the card: each loss term and
# weight_d finite and within BF16_BAND of the f32 one, relative or absolute
# (the hinge-G term is a mean of logits that cancel, ~0.03)
TRAIN_XCHECK = {"loss_rel": 1e-3, "state_rel": 1e-3, "param_max_lr": 2.1,
                "param_mean_lr": 0.01}
BF16_BAND = {"rel": 0.1, "abs": 0.02}
# InceptionV3 features on the card against the CPU (f32), relative to the
# largest feature: f32 with TF32 off differs by summation order over the
# 94 convolutions (1.5e-6 measured on an H100), bf16 by its roundings
# (0.013 measured), held to a band
INCEPTION_XCHECK = {"f32": 1e-4, "bf16": 0.1}
# cross-check bounds of a card model (bf16, and f32 with TF32 off) against
# f32 on the CPU through the plain versions; see cross_check(). Measured on
# an H100 with seeded random weights: bf16 decode 42.2 dB, 496/512 codes
# agree, each flip at a near-tie (deficit 0.0018); f32 110.9 dB, 512/512.
XCHECK_BOUNDS = {
    "bf16": {"decode_psnr_db": 35.0, "index_agreement": 0.9,
             "max_score_deficit": 0.01},
    "f32": {"decode_psnr_db": 80.0, "index_agreement": 0.99,
            "max_score_deficit": 1e-4},
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (out.stdout.strip() or out.stderr.strip()).splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, replays=5):
    """Mean device time of one call with the host out of it: every function
    of `fns` is called once while a CUDA graph captures, and the graph is
    replayed `replays` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured on the stream the calls were warmed up on (vq_nearest makes
    # its arrival counters at a stream's first launch, never in a capture)
    with torch.cuda.graph(graph, stream=side):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * len(fns))
    del graph
    return ms


def device_ms(fn, calls=20):
    """A call's device time: `calls` of it in one replayed CUDA graph."""
    return graph_ms([fn] * calls)


def cold_copies(nbytes):
    """How many distinct copies of `nbytes` of weights a cold timing cycles
    through: together COLD_BYTES, well past the card's L2."""
    return max(2, -(-COLD_BYTES // nbytes))


def cold_ms(make_fn, copies):
    """Device time of a call that finds its weights in device memory, not
    in L2, as a decode step does: `make_fn(i)` gives the call on the i-th
    copy of the weights, and one replayed graph cycles through them all."""
    return graph_ms([make_fn(i) for i in range(copies)], replays=3)


def launch_floor_ms():
    """Replay time of an empty kernel launch: no kernel's device_ms can be
    under it."""
    import ctypes
    import torch
    from favae_tpu_torch import _build
    fn = _build.library("empty_launch").favae_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty launch failed")
    return device_ms(launch, calls=50)


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def check_vq(n, k, d, metric, seed):
    import torch
    from favae_tpu_torch.ops import vq
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, device="cuda", generator=g)
    e = torch.randn(k, d, device="cuda", generator=g)
    if metric == "cosine":
        x = torch.nn.functional.normalize(x, dim=-1)
        e = torch.nn.functional.normalize(e, dim=-1)
        bias = None
    else:
        x, bias = 2.0 * x, -(e * e).sum(-1)
    idx = vq.vq_nearest(x, e, bias)
    idx_plain = vq.vq_nearest_plain(x, e, bias)
    torch.cuda.synchronize()
    scores = x.double() @ e.double().T
    if bias is not None:
        scores += bias.double()
    best = scores.max(dim=1).values
    gap = (best - scores.gather(1, idx.long()[:, None])[:, 0]).max().item()
    mismatch = int((idx != idx_plain).sum())
    b = torch.zeros(k, device="cuda") if bias is None else bias

    def library():
        return torch.argmax(torch.addmm(b, x, e.T), dim=-1)

    row = {
        "shape": f"N={n} K={k} D={d} {metric}",
        "max_abs_err": gap, "index_mismatches_vs_plain": mismatch,
        "ms": time_ms(lambda: vq.vq_nearest(x, e, bias)),
        "device_ms": device_ms(lambda: vq.vq_nearest(x, e, bias)),
        "plain_ms": time_ms(lambda: vq.vq_nearest_plain(x, e, bias)),
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
    }
    moved = 4 * (n * d + k * d + (k if bias is not None else 0) + n)
    # what the kernel does: three TF32 products for one of f32; beside it
    # the bound of the same function as f32 FMA outside the tensor cores
    row["bound_ms"], row["bound_by"] = bound(moved, 6 * n * k * d,
                                             TF32_FLOP_PER_S)
    row["bound_f32_fma_ms"] = bound(moved, 2 * n * k * d)[0]
    log("vq", json.dumps(row))
    if gap > VQ_NEAR_TIE:
        raise AssertionError(f"vq_nearest {row['shape']}: chosen code trails "
                             f"the best score by {gap} > {VQ_NEAR_TIE}")
    return row


def check_vq_ties(n=4096, k=1024, d=256, distinct=300, seed=4):
    """Many exact ties on the card: every code is a copy of one of
    `distinct` rows, so each token's best score is shared by three or four
    codes, bit for bit, and the kernel must name the lowest of them."""
    import torch
    from favae_tpu_torch.ops import vq
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(
        torch.randn(n, d, device="cuda", generator=g), dim=-1)
    base = torch.nn.functional.normalize(
        torch.randn(distinct, d, device="cuda", generator=g), dim=-1)
    owner = torch.randint(distinct, (k,), device="cuda", generator=g)
    e = base[owner].contiguous()
    idx = vq.vq_nearest(x, e).long()
    torch.cuda.synchronize()
    first = torch.full((distinct,), k, device="cuda", dtype=torch.long)
    first.scatter_reduce_(0, owner, torch.arange(k, device="cuda"), "amin")
    scores = x.double() @ e.double().T
    gap = (scores.max(dim=1).values
           - scores.gather(1, idx[:, None])[:, 0]).max().item()
    not_lowest = int((first[owner[idx]] != idx).sum())
    row = {"shape": f"N={n} K={k} D={d}, {distinct} distinct codes",
           "max_abs_err": gap, "not_the_lowest_index": not_lowest,
           "tokens_with_tied_best": int(
               (torch.bincount(owner, minlength=distinct)[owner[idx]] > 1
                ).sum())}
    log("vq-ties", json.dumps(row))
    if gap > VQ_NEAR_TIE or not_lowest:
        raise AssertionError(f"vq_nearest with duplicated codes: {row}")
    return row


def check_vq_streams(n=4096, k=1024, d=256, seed=5, rounds=20):
    """Launches in flight on two streams at once (code splits merged by
    arrival counters) each give the indices of a launch alone."""
    import torch
    from favae_tpu_torch.ops import vq
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(n, d, device="cuda", generator=g) for _ in range(2)]
    e = torch.nn.functional.normalize(
        torch.randn(k, d, device="cuda", generator=g), dim=-1)
    alone = [vq.vq_nearest(x, e) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(vq.vq_nearest(xs[i], e))
    torch.cuda.synchronize()
    wrong = sum(int((o != alone[i]).sum()) for i in range(2) for o in outs[i])
    counters = {vq._arrived(torch.device("cuda", torch.cuda.current_device()),
                            st.cuda_stream, False).data_ptr()
                for st in streams}
    row = {"shape": f"N={n} K={k} D={d}, 2 streams x {rounds} launches",
           "splits": vq.vq_plan(n, k).splits, "indices_differ": wrong,
           "counter_sets": len(counters)}
    log("vq-streams", json.dumps(row))
    if wrong or len(counters) != 2:
        raise AssertionError(f"vq_nearest on two streams at once: {row}")
    return row


def gn_census(model, x, fn=None, groups=None):
    """Distinct GroupNorm calls of one reconstruction (or of `fn(x)`):
    {key: calls}, with key = (N, C, H, W, act, in dtype, out dtype); each
    key's group count goes to `groups` where given."""
    import torch
    from favae_tpu_torch.models.blocks import GroupNormAct
    seen, not_cl = {}, [0]

    def hook(mod, args):
        t = args[0]
        key = (*t.shape, mod.act, str(t.dtype).split(".")[1],
               str(mod.dtype).split(".")[1])
        seen[key] = seen.get(key, 0) + 1
        not_cl[0] += not t.is_contiguous(memory_format=torch.channels_last)
        if groups is not None:
            groups[key] = mod.num_groups

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, GroupNormAct)]
    try:
        with torch.inference_mode():
            (fn or model.reconstruct)(x)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen, not_cl[0]


def check_gn(key, seed, groups=32):
    import torch
    import torch.nn.functional as F
    from favae_tpu_torch.ops import gn
    n, c, h, w, act, in_dt, out_dt = key
    in_dt, out_dt = getattr(torch, in_dt), getattr(torch, out_dt)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2 + 0.5).to(
        in_dt).contiguous(memory_format=torch.channels_last)
    scale = torch.randn(c, device="cuda", generator=g)
    bias = torch.randn(c, device="cuda", generator=g)
    hw, elems = h * w, n * c * h * w
    xb, yb, vec = elems * x.element_size(), elems * out_dt.itemsize, n * c * 4

    s, p = gn.gn_stats(x), gn.gn_stats_plain(x)
    # sums are compared relative to the sum of magnitudes they add up
    xf = x.float()
    mag = torch.stack([xf.abs().sum(dim=(2, 3)), p[:, 1]], dim=1)
    stats_rel = ((s - p).abs() / mag).max().item()
    stats_abs = (s - p).abs().max().item()

    a, b, _, _ = gn.gn_affine(p, scale, bias, groups, hw, 1e-5)
    y = gn.gn_apply(x, a, b, act, out_dt).float()
    yp = gn.gn_apply_plain(x, a, b, act, out_dt).float()
    apply_err = (y - yp).abs()
    # one rounding of out_dtype apart at most: 2^-7 relative for bf16
    apply_ok = bool((apply_err <= 1e-5 + 2 ** -7 * yp.abs()).all())

    full = gn.group_norm_act(x, scale, bias, groups, act=act, out_dtype=out_dt)
    full_plain = gn.group_norm_act_plain(x, scale, bias, groups, act=act,
                                         out_dtype=out_dt)
    full_err = (full.float() - full_plain.float()).abs().max().item()
    ws, bs = scale.to(in_dt), bias.to(in_dt)

    def library():
        y = F.group_norm(x, groups, ws, bs, 1e-5)
        return F.silu(y) if act == "silu" else y

    stats_bound = bound(xb + 2 * vec, 3 * elems)[0]
    apply_bound = bound(xb + yb + 2 * vec, 2 * elems)[0]
    row = {
        "shape": f"N={n} C={c} H={h} W={w} G={groups} act={act} "
                 f"{in_dt}->{out_dt}",
        "stats": {"max_abs_err": stats_abs, "max_rel_err": stats_rel,
                  "ms": time_ms(lambda: gn.gn_stats(x)),
                  "device_ms": device_ms(lambda: gn.gn_stats(x)),
                  "plain_ms": time_ms(lambda: gn.gn_stats_plain(x)),
                  "bound_ms": stats_bound},
        "apply": {"max_abs_err": apply_err.max().item(),
                  "ms": time_ms(lambda: gn.gn_apply(x, a, b, act, out_dt)),
                  "device_ms": device_ms(
                      lambda: gn.gn_apply(x, a, b, act, out_dt)),
                  "plain_ms": time_ms(
                      lambda: gn.gn_apply_plain(x, a, b, act, out_dt)),
                  "bound_ms": apply_bound},
        "group_norm_act": {
            "max_abs_err": full_err,
            "ms": time_ms(lambda: gn.group_norm_act(
                x, scale, bias, groups, act=act, out_dtype=out_dt)),
            "device_ms": device_ms(lambda: gn.group_norm_act(
                x, scale, bias, groups, act=act, out_dtype=out_dt)),
            "plain_ms": time_ms(lambda: gn.group_norm_act_plain(
                x, scale, bias, groups, act=act, out_dtype=out_dt)),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library),
            "bound_ms": bound(2 * xb + yb, 5 * elems)[0]},
    }
    log("gn", json.dumps(row))
    if stats_rel > 1e-5 or not apply_ok:
        raise AssertionError(f"group norm kernels disagree at {row['shape']}:"
                             f" stats rel err {stats_rel}, apply ok {apply_ok}")
    return row


def weighted(rows, census, part, field):
    """A GroupNorm number summed over the distinct shapes, each weighted by
    its calls (rows in census order): per recon batch for the forward
    census, per train step for the backward one."""
    return sum(r[part][field] * n for r, n in zip(rows, census.values()))


def kernel_rows(vq_main, gn_rows, census, bwd_rows, bwd_census, launches,
                recon_launches, cat_step_launches):
    """The `kernels` line: one entry per kernel. `launches` are the train
    slice's (every kernel runs there), `launches_recon` the recon slice's,
    `launches_cat_train_step` those of a CAT train step on the full
    pipeline (its frozen encode).
    The forward GroupNorm entries are per recon batch (`weighted` by the
    recon census), the backward ones per train step (by the train census); the backward entries carry
    the backward through F.silu(F.group_norm(...)) as library_ms, which
    computes the whole GroupNorm backward (both kernels and the fold); the
    forward ones F.silu(F.group_norm(...)) itself, which computes both
    forward kernels and the fold (eager and replayed in a CUDA graph)."""
    rows = [{
        "name": "vq_nearest", "route": "cuda",
        "source": "favae_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "favae_tpu/ops/vq_pallas.py:65",
        "launches": launches["vq_nearest"],
        "launches_recon": recon_launches["vq_nearest"],
        "launches_cat_train_step": cat_step_launches["vq_nearest"],
        "shape": vq_main["shape"],
        **{f: vq_main[f] for f in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_f32_fma_ms", "library_ms",
            "library_device_ms")}}]
    for name, part, replaces in (
            ("gn_stats", "stats", "favae_tpu/ops/gn_pallas.py:137"),
            ("gn_apply", "apply", "favae_tpu/ops/gn_pallas.py:178")):
        rows.append({
            "name": name, "route": "triton",
            "source": "favae_tpu_torch/ops/gn.py",
            "replaces": replaces, "launches": launches[name],
            "launches_recon": recon_launches[name],
            "launches_cat_train_step": cat_step_launches[name],
            "shape": f"{sum(census.values())} calls over {len(census)} "
                     "shapes, per recon batch",
            "max_abs_err": max(r[part]["max_abs_err"] for r in gn_rows),
            **{f: weighted(gn_rows, census, part, f)
               for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes",
            "library_ms": weighted(gn_rows, census, "group_norm_act",
                                   "library_ms"),
            "library_device_ms": weighted(gn_rows, census, "group_norm_act",
                                          "library_device_ms"),
            "library_is": "F.silu(F.group_norm(...)): stats, fold and apply"})
    lib = weighted(bwd_rows, bwd_census, "backward", "library_ms")
    for name, part, err, route, source, replaces in (
            ("gn_bwd_sums", "sums", "max_rel_err", "cuda",
             "favae_tpu_torch/csrc/gn_bwd_sums.cu",
             "favae_tpu/ops/gn_pallas.py:89"),
            ("gn_bwd_dx", "dx", "max_abs_err", "triton",
             "favae_tpu_torch/ops/gn.py",
             "favae_tpu/ops/gn_pallas.py:109")):
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_cat_train_step": cat_step_launches[name],
            "shape": f"{sum(bwd_census.values())} calls over "
                     f"{len(bwd_census)} shapes, per train step",
            "max_abs_err": max(r[part][err] for r in bwd_rows),
            "max_abs_err_is": "relative to the summed magnitudes"
                              if part == "sums" else "absolute",
            **{f: weighted(bwd_rows, bwd_census, part, f)
               for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": lib})
    return rows


def train_census(state, model_cfg, loss_cfg, train_cfg, x, groups=None):
    """One train step with the discriminator and one without, at the train
    slice's shapes (or those of the configs given): the distinct GroupNorm
    backward calls, keyed (N, C, H, W, act, x dtype, dy dtype) with their
    calls a step (each key's group count into `groups` where given), how
    many incoming gradients were not channels_last (copied by the
    backward), and each kernel's launches a step."""
    import torch
    from favae_tpu_torch.models.blocks import GroupNormAct
    from favae_tpu_torch.ops import gn, vq
    from favae_tpu_torch.train.favae_step import make_train_step
    seen = {}

    def hook(mod, args, out):
        if not out.requires_grad:
            return
        t = args[0]
        key = (*t.shape, mod.act, str(t.dtype).split(".")[1],
               str(out.dtype).split(".")[1])

        def on_grad(g):
            seen[key] = seen.get(key, 0) + 1
        out.register_hook(on_grad)
        if groups is not None:
            groups[key] = mod.num_groups

    handles = [m.register_forward_hook(hook) for m in state.model.modules()
               if isinstance(m, GroupNormAct)]
    per_step = {}
    try:
        for disc_on in (True, False):
            step = make_train_step(model_cfg, loss_cfg, train_cfg,
                                   disc_on=disc_on, ffl_on=True)
            before = {**vq.LAUNCHES, **gn.LAUNCHES}
            copies = gn.DY_COPIES["not_channels_last"]
            state, m = step(state, x)
            torch.cuda.synchronize()
            per_step[disc_on] = {k: v - before[k] for k, v in
                                 {**vq.LAUNCHES, **gn.LAUNCHES}.items()}
            per_step[disc_on]["dy_copies"] = (gn.DY_COPIES["not_channels_last"]
                                              - copies)
            if not math.isfinite(float(m["loss_g"])):
                raise AssertionError("census step: non-finite loss_g")
    finally:
        for h in handles:
            h.remove()
    calls = {k: v // 2 for k, v in seen.items()}  # two steps, one each
    return calls, per_step


def backward_kernels(fn):
    """Device kernels that one call of `fn` runs, from torch.profiler; None
    when the profiler records no device event at all (`fn` launches at
    least one kernel: the count is unknown, not 0)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return n or None


def replays_differing(fn, ref, replays=100):
    """How many of `replays` replays of a CUDA graph of one call of `fn`
    give other values than `ref` (fn returns a tuple of tensors)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the stream's arrival counters exist before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(replays):
        graph.replay()
        differ += torch.stack([(a != b).any() for a, b in zip(out, ref)]).any()
    del graph
    return int(differ)


def check_gn_bwd(key, seed, groups=32):
    """gn_bwd_sums (per-image sums, dscale, dbias, c2, c3) and gn_bwd_dx
    against their plain versions, and the whole autograd.Function backward
    against the plain Function, at one backward shape; the same bits on two
    calls and over 100 replays of a graph of the call; the device kernels
    of one backward call, beside those of the earlier design, "parent"
    (a Triton sums kernel with p, q, the sum over chunks and the fold in
    PyTorch: those operations counted here, plus its two Triton kernels);
    timed beside their bounds, the plain versions and the
    backward through F.silu(F.group_norm(...))."""
    import torch
    import torch.nn.functional as F
    from favae_tpu_torch.ops import gn
    n, c, h, w, act, in_dt, out_dt = key
    in_dt, out_dt = getattr(torch, in_dt), getattr(torch, out_dt)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2 + 0.5).to(
        in_dt).contiguous(memory_format=cl)
    dy = torch.randn(n, c, h, w, device="cuda", generator=g).to(
        out_dt).contiguous(memory_format=cl)
    scale = torch.randn(c, device="cuda", generator=g)
    bias = torch.randn(c, device="cuda", generator=g)
    hw, elems, cg = h * w, n * c * h * w, c // groups
    xb, dyb, vec = elems * x.element_size(), elems * dy.element_size(), n * c * 4

    a, b, mean, inv = gn.gn_affine(gn.gn_stats_plain(x), scale, bias, groups,
                                   hw, 1e-5)
    p = inv.expand(-1, -1, cg).reshape(n, c)
    q = (-mean * inv).expand(-1, -1, cg).reshape(n, c)

    def sums_call():
        return gn.gn_bwd_sums(x, dy, a, b, scale, mean, inv, act)

    k, kp = sums_call(), gn.gn_bwd_sums_fold_plain(x, dy, a, b, scale, mean,
                                                    inv, act)
    xf, gg = gn.act_grad_plain(x, dy, a, b, act)
    xhat = xf * p[:, :, None, None] + q[:, :, None, None]
    mag = torch.stack([gg.abs().sum(dim=(2, 3)),
                       (gg * xhat).abs().sum(dim=(2, 3))], dim=1)
    sums_rel = ((k.sums - kp.sums).abs() / mag.clamp_min(1e-30)).max().item()
    mag_s = mag.sum(0)
    ds_rel = max(
        ((k.dscale - kp.dscale).abs() / mag_s[1].clamp_min(1e-30)).max().item(),
        ((k.dbias - kp.dbias).abs() / mag_s[0].clamp_min(1e-30)).max().item())
    # c2, c3 relative to the magnitudes of the terms they add up: c3's
    # inv^2 sum |scale gx| / m, c2's inv sum |scale gs| / m + |c3 mean|
    m = hw * cg
    sa = scale.abs()

    def per_group(v):
        return (sa * v).view(n, groups, cg).sum(-1, keepdim=True)

    c3_mag = (inv * inv * per_group(mag[:, 1]) / m)
    c2_mag = inv * per_group(mag[:, 0]) / m + c3_mag * mean.abs()

    def chan(v):
        return v.expand(n, groups, cg).reshape(n, c)

    coef_rel = max(
        ((k.c2 - kp.c2).abs() / chan(c2_mag).clamp_min(1e-30)).max().item(),
        ((k.c3 - kp.c3).abs() / chan(c3_mag).clamp_min(1e-30)).max().item())
    again = sums_call()
    bits_twice = all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                     for u, v in zip(k, again))
    differ = replays_differing(sums_call, k)

    dx = gn.gn_bwd_dx(x, dy, a, b, kp.c2, kp.c3, act).float()
    dxp = gn.gn_bwd_dx_plain(x, dy, a, b, kp.c2, kp.c3, act).float()
    # one rounding of x.dtype apart at most, beside f32 error of the terms
    ulp = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}.get(in_dt, 1e-6)
    terms = (a[:, :, None, None] * gg).abs() + kp.c2.abs()[:, :, None, None] \
        + (kp.c3[:, :, None, None] * xf).abs()
    dx_err = (dx - dxp).abs()
    dx_ok = bool((dx_err <= 1e-5 * terms + ulp * dxp.abs() + 1e-6).all())

    # the whole Function, kernels against the plain versions, on the card
    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
        y = fn(*ins, groups, act=act, out_dtype=out_dt)
        if y.grad_fn is None:
            raise AssertionError("group_norm_act output on CUDA has no grad_fn")
        return y, ins, torch.autograd.grad(y, ins, dy, retain_graph=True)

    y, ins, (fdx, fds, fdb) = grads(gn.group_norm_act)
    _, _, (pdx, pds, pdb) = grads(gn.group_norm_act_plain)
    fn_dx_ok = bool(((fdx.float() - pdx.float()).abs()
                     <= 1e-5 * terms + ulp * pdx.float().abs() + 1e-4).all())
    fn_rel = max(((fds - pds).abs() / mag_s[1].clamp_min(1e-30)).max().item(),
                 ((fdb - pdb).abs() / mag_s[0].clamp_min(1e-30)).max().item())

    def backward():
        torch.autograd.grad(y, ins, dy, retain_graph=True)

    part = kp.sums.unsqueeze(1).repeat(1, 4, 1, 1)  # partials as it had them

    def parent_ops():  # its PyTorch operations beside its two kernels
        pp = inv.expand(-1, -1, cg).reshape(n, c)
        qq = (-mean * inv).expand(-1, -1, cg).reshape(n, c)
        gn.gn_bwd_fold(part.sum(dim=1), scale, mean, inv, hw)
        return pp, qq

    kernels = backward_kernels(backward)
    parent_kernels = backward_kernels(parent_ops)
    parent_kernels = None if parent_kernels is None else parent_kernels + 2

    ws, bs = scale.to(in_dt), bias.to(in_dt)
    xl = x.detach().clone().requires_grad_()
    wl, bl = ws.clone().requires_grad_(), bs.clone().requires_grad_()

    def lib_fwd():
        yl = F.group_norm(xl, groups, wl, bl, 1e-5)
        return F.silu(yl) if act == "silu" else yl

    yl = lib_fwd()

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), [xl, wl, bl], dy)

    def ours_fwd_bwd():
        yo = gn.group_norm_act(ins[0], ins[1], ins[2], groups, act=act,
                               out_dtype=out_dt)
        torch.autograd.grad(yo, ins, dy)

    n_ops_g = 15 if act == "silu" else 1
    row = {
        "shape": f"N={n} C={c} H={h} W={w} G={groups} act={act} "
                 f"{in_dt}/{out_dt}",
        "plan": list(gn.bwd_sums_plan(n, hw, c, x.element_size(),
                                      dy.element_size(), gn.sm_count(x.device))),
        "sums": {"max_rel_err": sums_rel, "dscale_dbias_max_rel_err": ds_rel,
                 "c2_c3_max_rel_err": coef_rel,
                 "same_bits_twice": bits_twice,
                 "replays_differing_of_100": differ,
                 "ms": time_ms(sums_call),
                 "device_ms": device_ms(sums_call),
                 "plain_ms": time_ms(lambda: gn.gn_bwd_sums_fold_plain(
                     x, dy, a, b, scale, mean, inv, act)),
                 "bound_ms": bound(xb + dyb + 6 * vec,
                                   (n_ops_g + 5) * elems)[0]},
        "dx": {"max_abs_err": dx_err.max().item(),
               "ms": time_ms(lambda: gn.gn_bwd_dx(x, dy, a, b, kp.c2, kp.c3,
                                                  act)),
               "device_ms": device_ms(lambda: gn.gn_bwd_dx(
                   x, dy, a, b, kp.c2, kp.c3, act)),
               "plain_ms": time_ms(lambda: gn.gn_bwd_dx_plain(
                   x, dy, a, b, kp.c2, kp.c3, act)),
               "bound_ms": bound(2 * xb + dyb + 4 * vec,
                                 (n_ops_g + 4) * elems)[0]},
        "backward": {
            "dscale_dbias_max_rel_err": fn_rel,
            "kernels_a_call": kernels, "parent_kernels_a_call": parent_kernels,
            "ms": time_ms(backward),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                yl, [xl, wl, bl], dy, retain_graph=True)),
            "bound_ms": bound(2 * xb + dyb, (n_ops_g + 9) * elems)[0]},
        "fwd_bwd": {"ms": time_ms(ours_fwd_bwd),
                    "library_ms": time_ms(lib_fwd_bwd)},
    }
    log("gn_bwd", json.dumps(row))
    if (sums_rel > 1e-5 or ds_rel > 1e-5 or coef_rel > 1e-5 or not dx_ok
            or not fn_dx_ok or fn_rel > 1e-5 or not bits_twice
            or differ or (kernels is not None and kernels > 3)):
        raise AssertionError(
            f"group norm backward disagrees at {row['shape']}: sums rel "
            f"{sums_rel}, dscale/dbias rel {ds_rel}, c2/c3 rel {coef_rel}, "
            f"dx ok {dx_ok}, Function dx ok {fn_dx_ok}, Function "
            f"dscale/dbias rel {fn_rel}, same bits twice {bits_twice}, "
            f"replays differing {differ}, kernels a backward "
            f"call {kernels}")
    return row


# the GroupNorm backward beyond the train step's shapes: imagenet_f4's first
# conv-FCM GroupNorm (3 channels in 3 groups), odd H*W with C % 8 != 0 rows
# at the image boundaries, and x and dy of other dtypes; (key, groups)
GN_BWD_EXTRA = [((2, 3, 64, 64, "silu", "bfloat16", "bfloat16"), 3),
                ((2, 64, 5, 5, "silu", "bfloat16", "bfloat16"), 16),
                ((3, 12, 7, 5, None, "float16", "float32"), 4),
                ((2, 128, 16, 16, "silu", "float32", "bfloat16"), 32)]


def check_gn_bwd_layout():
    """The built kernel's constants against ops/gn.py's copy of them."""
    from favae_tpu_torch.ops import gn
    want = (gn.BWD_CONSUMERS + 32, gn.BWD_CONSUMERS, gn.BWD_STAGES,
            gn.BWD_MAX_BLOCKS, gn.BWD_SMEM_MAX)
    got = gn.bwd_kernel_layout()
    log("gn_bwd-layout", json.dumps({"kernel": got, "python": want}))
    if got != want:
        raise AssertionError(f"csrc/gn_bwd_sums.cu's layout {got} is not "
                             f"ops/gn.py's {want}")


# ---------------------------------------------------------------------------
# phase 3b: the int8 kernels of CAT serving
# ---------------------------------------------------------------------------

# A kernel and its plain version round at the same places and differ in the
# order of their f32 sums, which can move a result across a bf16 rounding
# boundary: outputs may differ by one bf16 rounding (2^-7 relative) of the
# element, plus a small share of the output's largest magnitude for roundings
# that flipped upstream (xn, h, q, p) and spread over a row.
BF16_ULP = 2.0 ** -7
INT8_SPREAD = {"matmul_int8": 1e-5, "ffn_int8": 2.0 ** -9,
               "decode_step": 2.0 ** -7}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def close_to_plain(name, y, yp):
    """(ok, max abs err, elements that differ) of a kernel's bf16 output
    against its plain version's."""
    y, yp = y.float(), yp.float()
    err = (y - yp).abs()
    tol = BF16_ULP * yp.abs() + INT8_SPREAD[name] * yp.abs().max()
    return bool((err <= tol).all()), err.max().item(), int((err > 0).sum())


def check_matmul_int8(m, k, n, seed):
    import torch
    from favae_tpu_torch.ops import int8_matmul as im
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32)).cuda()
    wq, scale = im.quantize_weight(w)
    y = im.matmul_int8(x, wq, scale)
    torch.cuda.synchronize()
    yp = im.matmul_int8_plain(x, wq, scale)
    ok, err, differ = close_to_plain("matmul_int8", y, yp)
    again = im.matmul_int8(x, wq, scale)
    wd = (wq.bfloat16() * scale.bfloat16())  # pre-dequantised, for the yardstick
    copies = cold_copies(wq.numel())
    wqs = [wq.clone() for _ in range(copies)]
    wds = [wd.clone() for _ in range(copies)]
    row = {"shape": f"M={m} K={k} N={n}", "max_abs_err": err,
           "elements_differ": differ, "out_max": yp.float().abs().max().item(),
           "same_bits_twice": bool(torch.equal(y, again)),
           "ms": time_ms(lambda: im.matmul_int8(x, wq, scale)),
           "device_ms": device_ms(lambda: im.matmul_int8(x, wq, scale)),
           "cold_ms": cold_ms(
               lambda i: lambda: im.matmul_int8(x, wqs[i], scale), copies),
           "cold_copies": copies,
           "plain_ms": time_ms(lambda: im.matmul_int8_plain(x, wq, scale)),
           "library_ms": time_ms(lambda: x @ wd),
           "library_device_ms": device_ms(lambda: x @ wd),
           "library_cold_ms": cold_ms(lambda i: lambda: x @ wds[i], copies)}
    del wqs, wds
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(x, wq, scale, y), 2 * m * k * n, BF16_FLOP_PER_S)
    log("matmul_int8", json.dumps(row))
    if not ok or not row["same_bits_twice"]:
        raise AssertionError(f"matmul_int8 {row['shape']}: max abs err {err} "
                             "beyond one bf16 rounding, or bits changed "
                             "between two runs")
    return row


def ffn_case(rows, k, seed):
    """Seeded inputs and int8 weights of one FFN block on the card."""
    import torch
    from favae_tpu_torch.ops import ffn_int8 as fi
    rng = np.random.RandomState(seed)
    f = 4 * k

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    x = t(rng.randn(rows, k)).bfloat16()
    g_in, g_mid = t(1 + 0.1 * rng.randn(k)), t(1 + 0.1 * rng.randn(f))
    prep = fi.prepare_ffn_weights(t(rng.randn(k, f) * 0.05), g_mid,
                                  t(rng.randn(f, k) * 0.05))
    return x, g_in, prep


def check_ffn_plan(rows, k):
    """The library's work items, scratch, counters and shared memory against
    their Python copies in ops/ffn_int8.py."""
    import torch
    from favae_tpu_torch.ops import ffn_int8 as fi
    p = fi.ffn_plan(k, 4 * k, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    got = fi.kernel_layout(rows, p)
    cnt = fi.counter_layout(p)
    want = {"items": [fi.work_items(p, 0), fi.work_items(p, 1)],
            "scratch": fi.scratch_layout(rows, p)["total"][1],
            "counters": (cnt["fin1"][0], cnt["cnt2"][0], cnt["total"][1]),
            "slots": p["slots"], "smem": fi.smem_bytes(p, p["slots"], rows)}
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"ffn_int8 rows={rows} K={k}: the kernel's "
                                 f"{key} differs from its Python copy")
    return {"kc1": p["kc1"], "kc2": p["kc2"], "slots": p["slots"],
            "smem_bytes": want["smem"], "items": [len(v) for v in want["items"]]}


def check_ffn_int8(rows, k, seed, timed=False):
    """One FFN block against its plain version: within one bf16 rounding, one
    launch a call, the same bits twice and across 100 replays of a CUDA graph
    of the call; timed (`timed`) three ways beside the plain version."""
    import torch
    from favae_tpu_torch.ops import ffn_int8 as fi
    x, g_in, prep = ffn_case(rows, k, seed)
    f = 4 * k
    plan = check_ffn_plan(rows, k)
    fi.LAUNCHES["ffn_int8"] = 0
    y = fi.ffn_block_int8(x, g_in, prep)
    launches = fi.LAUNCHES["ffn_int8"]
    torch.cuda.synchronize()
    yp = fi.ffn_block_int8_plain(x, g_in, prep)
    ok, err, differ = close_to_plain("ffn_int8", y, yp)
    again = fi.ffn_block_int8(x, g_in, prep)
    differ_replays = replays_differing(
        lambda: (fi.ffn_block_int8(x, g_in, prep),), (y,))
    row = {"shape": f"rows={rows} K={k} F={f}", "max_abs_err": err,
           "elements_differ": differ, "out_max": yp.float().abs().max().item(),
           "launches_a_call": launches,
           "same_bits_twice": bool(torch.equal(y, again)),
           "replays_differing_of_100": int(differ_replays), "plan": plan,
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(x, g_in, y, *prep.values()), 4 * rows * k * f, BF16_FLOP_PER_S)
    if timed:
        copies = cold_copies(nbytes(*prep.values()))
        preps = [{n: v.clone() for n, v in prep.items()}
                 for _ in range(copies)]
        row.update({
            "ms": time_ms(lambda: fi.ffn_block_int8(x, g_in, prep)),
            "device_ms": device_ms(lambda: fi.ffn_block_int8(x, g_in, prep)),
            "cold_ms": cold_ms(
                lambda i: lambda: fi.ffn_block_int8(x, g_in, preps[i]), copies),
            "cold_copies": copies,
            "plain_ms": time_ms(lambda: fi.ffn_block_int8_plain(x, g_in,
                                                                prep))})
        del preps
    log("ffn_int8", json.dumps(row))
    if not (ok and launches == 1 and row["same_bits_twice"]
            and row["replays_differing_of_100"] == 0):
        raise AssertionError(f"ffn_block_int8 {row['shape']}: max abs err "
                             f"{err} beyond tolerance, {launches} launches a "
                             "call, or bits changed between runs")
    return row


def check_ffn_streams(rows=8, k=1280, seed=32, rounds=20):
    """Launches in flight on two streams at once (each stream its own
    arrival counters) each give the bits of a launch alone."""
    import torch
    from favae_tpu_torch.ops import ffn_int8 as fi
    x, g_in, prep = ffn_case(rows, k, seed)
    xs = [x, x.flip(0).contiguous()]
    alone = [fi.ffn_block_int8(v, g_in, prep) for v in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fi.ffn_block_int8(xs[i], g_in, prep))
    torch.cuda.synchronize()
    wrong = sum(int((o != alone[i]).sum()) for i in range(2) for o in outs[i])
    counters = {fi._arrived(torch.device("cuda", torch.cuda.current_device()),
                            st.cuda_stream, False).data_ptr()
                for st in streams}
    row = {"shape": f"rows={rows} K={k}, 2 streams x {rounds} launches",
           "elements_differ": wrong, "counter_sets": len(counters)}
    log("ffn-streams", json.dumps(row))
    if wrong or len(counters) != 2:
        raise AssertionError(f"ffn_block_int8 on two streams at once: {row}")
    return row


def decode_replay(xs, rel_all, cross_kv, cross_bias, fused, cfg):
    """The whole-step kernel's 256 positions in order on one cache, the
    position a device scalar that the step advances in place: once as one
    captured step replayed (`graphs.run_steps`), once called eagerly 256
    times. Both must give the same x at every position and the same cache,
    bit for bit, with one launch a position."""
    import torch
    from favae_tpu_torch.graphs import run_steps
    from favae_tpu_torch.ops import decode_step_kernel as dk
    seq = xs.shape[0]

    def loop(graphed):
        caches = torch.zeros(cfg.n_layer, xs.shape[1], seq, cfg.dim_head,
                             dtype=torch.bfloat16, device="cuda")
        outs = torch.empty_like(xs)
        pos = torch.zeros((), dtype=torch.long, device="cuda")

        def step():
            at = pos.view(1)
            x_new, _ = dk.decode_step_fused(
                xs.index_select(0, at)[0], pos, caches, cross_kv, cross_bias,
                rel_all.index_select(0, at)[0], fused, cfg)
            outs.index_copy_(0, at, x_new[None])
            pos.add_(1)

        before = dk.LAUNCHES["decode_step"]
        if graphed:
            run_steps(step, seq, "cuda")
        else:
            for _ in range(seq):
                step()
        torch.cuda.synchronize()
        return outs, caches, dk.LAUNCHES["decode_step"] - before

    xg, cg, ng = loop(True)
    xe, ce, ne = loop(False)
    dk.check_positions(xs.device)
    out = {"x_same_bits": bool(torch.equal(xg, xe)),
           "caches_same_bits": bool(torch.equal(cg, ce)),
           "launches_replayed": ng, "launches_eager": ne}
    if not (out["x_same_bits"] and out["caches_same_bits"]
            and ng == ne == seq):
        raise AssertionError(f"decode_step replayed against eager: {out}")
    return out


def check_decode_step(gpt_name="gpt2_medium", rows=8, m_cross=78, seed=11,
                      check_at=(0, 1, 128, 255), **widths):
    """The whole-step kernel at full width and depth with seeded random
    weights (`widths` replaces fields of the preset): 256 positions in order
    on one cache; at `check_at` the plain version takes the same inputs and
    a copy of the cache as it stood, and the kernel takes them again with
    the position a device scalar (the int call's bits); a position outside
    the cache counts in the error word, raises there and writes nothing;
    then `decode_replay`."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops import decode_step_kernel as dk
    cfg = dataclasses.replace(
        getattr(C, gpt_name)(vocab_size=1024, n_cond_embed=768), **widths)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = GPT(cfg).cuda().eval()
    with torch.inference_mode():
        fused = dk.prepare_fused_decode(gpt, cfg)
    n_layer, heads, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    seq = cfg.image_encoded_dim ** 2
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    # what the kernel derives from the plan, against its mirror in Python
    plan = dk.plan(cfg, torch.cuda.get_device_properties(0).multi_processor_count)
    lib = dk._library()
    scratch = lib.favae_decode_step_scratch(
        rows, d, heads, plan["f"], plan["kc_q"], plan["kc_o"], plan["kc_1"],
        plan["kc_2"])
    smem = lib.favae_decode_step_smem(d, seq, m_cross, plan["kc_q"])
    if (scratch != dk.scratch_layout(rows, plan)["total"][1]
            or smem != dk.smem_bytes(d, seq, m_cross, plan["kc_q"])):
        raise AssertionError(f"decode_step: the kernel's scratch {scratch} "
                             f"or shared memory {smem} differs from "
                             "scratch_layout / smem_bytes")
    for prod, (k, n, kc) in dk.products(plan).items():
        if dk.kernel_items(k, n, kc, rows) != dk.work_items(k, n, kc, rows):
            raise AssertionError(f"decode_step: the kernel's work items of "
                                 f"{prod} differ from work_items")
    grid = lib.favae_decode_step_grid(d, seq, m_cross, plan["kc_q"])
    cross_kv = t(n_layer, rows, m_cross, dh).bfloat16()
    cross_bias = torch.zeros(rows, m_cross, device="cuda")
    cross_bias[rows // 2:, 1:] = -1e9      # the null-text half of a CFG batch
    cross_bias[0, 20:] = -1e9              # a short prompt
    rel_all = t(seq, n_layer, heads, seq + 1)   # one bias row per position
    rel_all[..., 0] = 0.0
    xs = t(seq, rows, d).bfloat16()
    caches = torch.zeros(n_layer, rows, seq, dh, device="cuda",
                         dtype=torch.bfloat16)
    checks, x_new = {}, None

    def at(pos):  # the position as a device scalar
        return torch.full((), pos, dtype=torch.long, device="cuda")

    with torch.inference_mode():
        for pos in range(seq):
            before = caches.clone() if pos in check_at else None
            args = (cross_kv, cross_bias, rel_all[pos].contiguous(), fused,
                    cfg)
            x_new, out = dk.decode_step_fused(xs[pos], pos, caches, *args)
            if pos == 0:
                torch.cuda.synchronize()   # a fault in the first launch
            if before is None:
                continue
            if out.data_ptr() != caches.data_ptr():
                raise AssertionError("decode_step_fused returned a new cache")
            on_card = before.clone()
            x_dev, _ = dk.decode_step_fused(xs[pos], at(pos), on_card, *args)
            ref = before.clone()
            xp, _ = dk.decode_step_fused_plain(xs[pos], pos, ref, *args)
            ok, err, differ = close_to_plain("decode_step", x_new, xp)
            row_err = (caches[:, :, pos].float()
                       - ref[:, :, pos].float()).abs().max().item()
            # rows of deeper layers come from an x that already differs
            row_ok = close_to_plain("decode_step", caches[:, :, pos],
                                    ref[:, :, pos])[0]
            keep = torch.ones(seq, dtype=torch.bool, device="cuda")
            keep[pos] = False
            untouched = bool(torch.equal(caches[:, :, keep], before[:, :, keep]))
            checks[pos] = {"x_max_abs_err": err, "x_elements_differ": differ,
                           "x_mean_abs_err": (x_new.float() - xp.float()
                                              ).abs().mean().item(),
                           "x_max": xp.float().abs().max().item(),
                           "cache_row_max_abs_err": row_err,
                           "other_cache_rows_untouched": untouched,
                           "device_pos_same_bits": bool(
                               torch.equal(x_dev, x_new)
                               and torch.equal(on_card, caches)),
                           "finite": bool(torch.isfinite(x_new.float()).all())}
            if not (ok and row_ok and untouched and checks[pos]["finite"]
                    and checks[pos]["device_pos_same_bits"]):
                raise AssertionError(f"decode_step_fused at pos {pos}: "
                                     f"{checks[pos]}")
        pos = seq - 1
        args = (cross_kv, cross_bias, rel_all[pos].contiguous(), fused, cfg)
        # positions outside the cache: counted on the card, nothing written,
        # raised by check_positions; the launches after them are right
        x_last, kept = x_new, caches.clone()
        dk.decode_step_fused(xs[pos], at(seq), caches, *args)
        errors = dk.position_errors(caches.device)
        dk.decode_step_fused(xs[pos], at(-1), caches, *args)
        try:
            dk.check_positions(caches.device)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        x_after, _ = dk.decode_step_fused(xs[pos], at(pos), caches, *args)
        bad_pos = {"errors_counted": errors, "raised": raised,
                   "cache_untouched": bool(torch.equal(caches, kept)),
                   "next_launch_same_bits": bool(torch.equal(x_after,
                                                             x_last))}
        if not (errors == 1 and raised and all(bad_pos.values())):
            raise AssertionError(f"decode_step at pos {seq} and -1: {bad_pos}")
        # timed as the token graph launches it, the position a device
        # scalar; the int call (which first fills such a scalar) beside it
        pos_t, first_t = at(pos), at(0)
        ms = time_ms(lambda: dk.decode_step_fused(xs[pos], pos_t, caches,
                                                  *args))
        ms_int = time_ms(lambda: dk.decode_step_fused(xs[pos], pos, caches,
                                                      *args))
        ms_first = time_ms(lambda: dk.decode_step_fused(xs[0], first_t,
                                                        caches, *args))
        # a step streams all of the model's int8 weights (more than the L2
        # holds), so its device time is its cold time
        dev_ms = device_ms(lambda: dk.decode_step_fused(
            xs[pos], pos_t, caches, *args), calls=10)
        dev_ms_int = device_ms(lambda: dk.decode_step_fused(
            xs[pos], pos, caches, *args), calls=10)
        dev_ms_first = device_ms(lambda: dk.decode_step_fused(
            xs[0], first_t, caches, *args), calls=10)
        plain_ms = time_ms(lambda: dk.decode_step_fused_plain(
            xs[pos], pos, caches, *args), iters=3, warmup=1)
        plain_ms_first = time_ms(lambda: dk.decode_step_fused_plain(
            xs[0], 0, caches, *args), iters=3, warmup=1)
        # phases and grid barriers of a layer, counted from the times the
        # kernel writes: one when block 0 passed the set-up's barrier and
        # one after each phase (the last without a barrier)
        clock = torch.zeros(2 * (1 + len(dk.PHASES) * n_layer),
                            dtype=torch.int64, device="cuda")
        dk.decode_step_fused(xs[pos], pos, caches, *args, phase_clock=clock)
        stamps = int((clock[:clock.numel() // 2] != 0).sum())
        replay = decode_replay(xs, rel_all, cross_kv, cross_bias, fused, cfg)
    if (stamps - 1) % n_layer or (stamps - 1) // n_layer != len(dk.PHASES):
        raise AssertionError(f"decode_step: the kernel wrote {stamps} phase "
                             f"times over {n_layer} layers, PHASES names "
                             f"{len(dk.PHASES)} a layer")
    weights = 2 * rows * sum(fused[n][0].numel() * n_layer for n in (
        "wq_s", "wo_s", "wq_c", "wo_c", "w1q", "w2q", "wkv"))
    attn = 4 * rows * heads * dh * n_layer * (seq + 1 + m_cross)
    moved = (nbytes(xs[pos], x_new, cross_kv, cross_bias, rel_all[pos],
                    *fused.values())
             + nbytes(caches[:, :, :seq]))   # pos + 1 = seq rows: read, 1 written
    row = {"shape": f"{gpt_name} L={n_layer} rows={rows} d={d} H={heads} "
                    f"S={seq} M={m_cross} pos={pos}",
           "checks": checks,
           "max_abs_err": max(c["x_max_abs_err"] for c in checks.values()),
           "ms": ms, "device_ms": dev_ms, "cold_ms": dev_ms,
           "ms_int_pos": ms_int, "device_ms_int_pos": dev_ms_int,
           "positions_outside": bad_pos, "replay": replay,
           "plain_ms": plain_ms, "ms_at_pos_0": ms_first,
           "device_ms_at_pos_0": dev_ms_first,
           "plain_ms_at_pos_0": plain_ms_first, "library_ms": None,
           "weight_bytes": nbytes(*fused.values()),
           "phases_per_layer": (stamps - 1) // n_layer,
           "grid_barriers_per_layer": (stamps - 1) // n_layer,
           "grid_blocks": grid, "plan": plan,
           "scratch_floats": scratch, "smem_bytes": smem}
    row["bound_ms"], row["bound_by"] = bound(moved, weights + attn,
                                             BF16_FLOP_PER_S)
    log("decode_step", json.dumps(row))
    del gpt, fused
    torch.cuda.empty_cache()
    return row


def add_ln_a_token(cfg):
    """`ln_fused` launches of one `GPT.sample` token step: the embedding's
    boundary into the first layer, then four a layer (the two attention
    boundaries, the feed-forward's middle, its boundary into the next layer
    or `final_norm`)."""
    return 1 + 4 * cfg.n_layer


def add_ln_cases(d, dtype, seed):
    """Every form of `ln_fused` at width d, 8 rows, inputs as the token step
    gives them: {form: (kernel call, plain call)}."""
    import torch
    from favae_tpu_torch.ops import ln_fused as lf
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).cuda()

    h32 = t(8, 1, d, scale=3.0)
    h, x = h32.to(dtype), t(8, 1, d).to(dtype)
    g_out, g_next = 1 + t(d, scale=0.2), 1 + t(d, scale=0.2)
    args = {"boundary": (h, x, g_out, g_next, dtype),
            "residual": (h, x, None, g_next, dtype),
            "init": (h32, None, g_out, g_next, dtype),
            "final": (h, x, None, g_next, torch.float32)}
    cases = {form: (lambda a=a: lf.add_ln(*a), lambda a=a: lf.add_ln_plain(*a))
             for form, a in args.items()}
    cases["gelu"] = (lambda: (lf.gelu_ln(h, g_next, dtype),),
                     lambda: (lf.gelu_ln_plain(h, g_next, dtype),))
    return cases, h, x, g_out, g_next


def rounding_ratio(got, want):
    """max |got - want| / (eps (|want| + 2 x its row's largest)), eps the
    stored dtype's: at most 1 is within a rounding of the stored dtype, of
    the element and of its row's largest for each of the (up to two)
    LayerNorms of the chain, whose f32 sums run in another order (a
    residual element rounded the other way moves the row's statistics by
    that much). Measured on an H100 against one row's largest alone: up to
    0.81 in bf16 outputs, 1.013 in f32 ones (two LayerNorms at 6144)."""
    import torch
    eps = torch.finfo(want.dtype).eps
    got, want = got.float(), want.float()
    row = want.abs().amax(-1, keepdim=True)
    return ((got - want).abs() / (eps * (want.abs() + 2 * row))).max().item()


def check_add_ln(seed=40):
    """Row 8: `ln_fused`'s kernel against its plain op sequence on the card,
    every form at both gpt2_medium widths in bf16 and f32: one launch a
    call, the plain version's dtypes and shapes, within a rounding of the
    stored dtype (`rounding_ratio` <= 1), the same bits twice; timed three
    ways beside the plain sequence (`plain_ms` eager, `plain_device_ms` in
    a graph, as the token graph ran it before the kernel) at the forms the
    token step runs most: the attention boundary at 8 x 1536 and the
    feed-forward's middle at 8 x 6144."""
    import torch
    from favae_tpu_torch.ops import ln_fused as lf
    rows, worst, bad = {}, {}, []
    with torch.inference_mode():
        for i, (d, dtype) in enumerate(
                (d, dt) for d in (1536, 6144)
                for dt in (torch.bfloat16, torch.float32)):
            cases = add_ln_cases(d, dtype, seed + i)[0]
            for form, (kernel, plain) in cases.items():
                before = lf.LAUNCHES["add_ln"]
                got = kernel()
                launched = lf.LAUNCHES["add_ln"] - before
                want, again = plain(), kernel()
                ratio = max(rounding_ratio(g, w) for g, w in zip(got, want))
                key = f"{form} {str(dtype)[6:]} d={d}"
                worst[key] = ratio
                if not (launched == 1 and ratio <= 1
                        and all(g.dtype == w.dtype and g.shape == w.shape
                                and torch.equal(g, a)
                                for g, w, a in zip(got, want, again))):
                    bad.append((key, launched, ratio))
        for d, form in ((1536, "boundary"), (6144, "gelu")):
            cases, h, x, g_out, g_next = add_ln_cases(d, torch.bfloat16, seed)
            kernel, plain = cases[form]
            row = {"shape": f"rows=8 d={d} {form} bf16",
                   "max_rounding_ratio": worst[f"{form} bfloat16 d={d}"],
                   "ms": time_ms(kernel), "device_ms": device_ms(kernel),
                   "plain_ms": time_ms(plain),
                   "plain_device_ms": device_ms(plain),
                   "library_ms": None}
            out = kernel()
            row["bound_ms"], row["bound_by"] = bound(
                nbytes(h, g_next, *out) + (nbytes(x, g_out)
                                           if form == "boundary" else 0), 0)
            rows[form] = row
            log("add_ln", json.dumps(row))
    log("add_ln rounding ratios", json.dumps(worst))
    if bad:
        raise AssertionError(f"add_ln against its plain version (form, "
                             f"launches, rounding ratio): {bad}")
    return rows


def add_ln_kernel_row(rows, launches):
    """The `kernels` line's entry for row 8, with the launches of the serve
    slice's exact run."""
    return {"name": "add_ln", "route": "triton",
            "source": "favae_tpu_torch/ops/ln_fused.py",
            "replaces": "the token step's LayerNorm chains, which XLA fuses "
                        "(favae_tpu/models/gpt.py)",
            "launches": launches, "on_main_path": True,
            **rows["boundary"], "gelu": rows["gelu"]}


def mqa_decode_a_token(cfg):
    """`mqa_decode` launches of one `GPT.sample` token step: a
    self-attention and a cross-attention a layer."""
    return 2 * cfg.n_layer


def mqa_decode_case(pos, heads=16, s=256, m=77, rows=8, dh=64, seed=50):
    """Both forms of `mqa_decode` at gpt2_medium's attention (8 CFG rows,
    16 heads of 64, a 256-row cache at `pos`, 77 text tokens plus the
    null), bf16, inputs as the token step gives them: {form: (kernel call,
    plain call)}, each call on its own copy of the cache, and the inputs."""
    import torch
    from favae_tpu_torch.models.gpt import _rel_pos_indices
    from favae_tpu_torch.ops import mqa_decode as md
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).cuda()

    bf = torch.bfloat16
    q, kv = t(rows, 1, heads * dh, scale=3.0).to(bf), t(rows, 1, dh).to(bf)
    cache = t(rows, s, dh).to(bf)
    cache[:, pos:] = 0
    grid = int(round(s ** 0.5))
    table = t((2 * grid - 1) ** 2, heads)
    idx = torch.from_numpy(_rel_pos_indices(grid)).long().cuda()
    null, at = t(dh), torch.tensor(pos, device="cuda")
    kv_text = t(rows, m, dh).to(bf)
    lengths = rng.randint(1, m, rows // 2)
    text = torch.from_numpy(np.arange(m)[None] < lengths[:, None]).cuda()
    mask = torch.cat([text, torch.zeros_like(text)], 0)
    caches = {"kernel": cache.clone(), "plain": cache.clone()}
    cases = {
        "self": (lambda: md.self_attend(q, kv, caches["kernel"], at, null,
                                        table, idx),
                 lambda: md.self_attend_plain(q, kv, caches["plain"], at,
                                              null, table, idx)),
        "cross": (lambda: md.cross_attend(q, kv_text, mask, null),
                  lambda: md.cross_attend_plain(q, kv_text, mask, null))}
    # the bytes a call must move: its inputs read once (at pos, the cache
    # rows to it; the position's row of the index table and its bias
    # entries), its output (and the cache row) written once
    need = {"self": nbytes(q, kv, cache[:, :pos + 1], null, q, kv)
            + s * (idx.element_size() + heads * table.element_size()),
            "cross": nbytes(q, kv_text, mask, null, q)}
    return cases, caches, need


def bf16_rounding_ratio(got, want):
    """max |got - want| over one rounding of the stored dtype of the
    output's largest magnitude: at most 1 is within it."""
    import torch
    eps = torch.finfo(want.dtype).eps
    return ((got.float() - want.float()).abs().max()
            / (eps * want.float().abs().max())).item()


def check_mqa_decode():
    """Row 9: `mqa_decode`'s kernel against its plain op sequence on the
    card, both forms at gpt2_medium's attention (`mqa_decode_case`) at
    positions 0, 128 and 255, and the self form at gpt2_mini's 24 heads:
    one launch a call, the plain version's dtype and shape, within a bf16
    rounding of the output's largest magnitude, the cache written as the
    plain version writes it, the same bits twice; timed at position 255
    (257 keys) three ways beside the bytes' bound and the plain sequence
    (`plain_ms` eager, `plain_device_ms` in a graph, as the token graph ran
    it before the kernel)."""
    import torch
    from favae_tpu_torch.ops import mqa_decode as md
    rows, worst, bad = {}, {}, []
    with torch.inference_mode():
        for heads, pos in [(16, 0), (16, 128), (16, 255), (24, 255)]:
            cases, caches, _ = mqa_decode_case(pos, heads)
            for form, (kernel, plain) in cases.items():
                before = md.LAUNCHES["mqa_decode"]
                got = kernel()
                launched = md.LAUNCHES["mqa_decode"] - before
                want, again = plain(), kernel()
                key = f"{form} heads={heads} pos={pos}"
                worst[key] = bf16_rounding_ratio(got, want)
                if not (launched == 1 and worst[key] <= 1
                        and got.dtype == want.dtype
                        and got.shape == want.shape
                        and torch.equal(got, again)
                        and torch.equal(caches["kernel"], caches["plain"])):
                    bad.append((key, launched, worst[key]))
        for form in ("self", "cross"):
            cases, _, need = mqa_decode_case(255)
            kernel, plain = cases[form]
            row = {"shape": f"rows=8 heads=16 dh=64 keys="
                            f"{257 if form == 'self' else 78} {form} bf16",
                   "max_rounding_ratio": worst[f"{form} heads=16 pos=255"],
                   "ms": time_ms(kernel), "device_ms": device_ms(kernel),
                   "plain_ms": time_ms(plain),
                   "plain_device_ms": device_ms(plain), "library_ms": None}
            row["bound_ms"], row["bound_by"] = bound(need[form], 0)
            rows[form] = row
            log("mqa_decode", json.dumps(row))
    log("mqa_decode rounding ratios", json.dumps(worst))
    if bad:
        raise AssertionError(f"mqa_decode against its plain version (case, "
                             f"launches, rounding ratio): {bad}")
    return rows


def mqa_decode_kernel_row(rows, launches):
    """The `kernels` line's entry for row 9, with the launches of the serve
    slice's exact run."""
    return {"name": "mqa_decode", "route": "triton",
            "source": "favae_tpu_torch/ops/mqa_decode.py",
            "replaces": "the token step's attention chains, which XLA fuses "
                        "(favae_tpu/models/gpt.py)",
            "launches": launches, "on_main_path": True,
            **rows["self"], "cross": rows["cross"]}


def rows_gemm_a_token(cfg):
    """`rows_gemm` launches of one exact token step: a layer's seven
    products (self-attention to_q, to_kv, to_out; cross-attention to_q,
    to_out; fc1, fc2). The cross-attention's K/V of the text, 616 rows in
    the serve slice, keeps cuBLAS."""
    return 7 * cfg.n_layer


def rows_gemm_shapes():
    """{"<model>.<product>": (K, N)} of the token step's products at
    gpt2_medium and gpt2_large (the cross-attention's to_q and to_out are
    the self-attention's shapes)."""
    from favae_tpu_torch import config as C
    shapes = {}
    for name in ("gpt2_medium", "gpt2_large"):
        c = getattr(C, name)(vocab_size=1024)
        d, inner = c.n_embed, c.n_head * c.dim_head
        for proj, kn in (("to_q", (d, inner)), ("to_kv", (d, c.dim_head)),
                         ("to_out", (inner, d)), ("fc1", (d, 4 * d)),
                         ("fc2", (4 * d, d))):
            shapes[f"{name}.{proj}"] = kn
    return shapes


def rows_gemm_bound(x, w, want):
    """What the kernel's f32 sum and the plain version's, in two orders of
    the same bf16 products, each rounded once to bf16, may differ by: K
    eps32 of the sum of |products| each, and a bf16 rounding of the output
    each (tests/test_torch_port_rows_gemm.py::sum_bound)."""
    import torch
    k = x.shape[-1]
    return (torch.finfo(torch.bfloat16).eps * want.float().abs()
            + 2 * k * torch.finfo(torch.float32).eps
            * (x.float().abs() @ w.float().abs().t()))


def check_rows_gemm(rows_list=(2, 8, 9, 16), timed_rows=(8, 16)):
    """Row 10: `rows_linear` against its plain version on the card at every
    product of gpt2_medium's and gpt2_large's token step, at 2 to 16 rows
    (`rows_gemm.MAX_ROWS`): one launch a call, the plain version's dtype
    and shape, within `rows_gemm_bound`, the same bits twice. At 8 and 16
    rows each shape is
    timed in CUDA graphs against cuBLAS (`F.linear`, as the token step ran
    it before the kernel): hot (20 calls of one weight) and cold (a graph
    cycling through COLD_BYTES of distinct weight copies, so nothing is
    found in L2, as in the token step), beside the bytes' bound. Every
    plan's `Plan.smem()` is the library's `favae_rows_gemm_smem`. Raises on
    a wrong result or a count that differs."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from favae_tpu_torch import _build
    from favae_tpu_torch.ops import rows_gemm as rg
    rows_out, worst, bad = {}, {}, []
    rng = np.random.RandomState(60)
    smem = _build.library("rows_gemm").favae_rows_gemm_smem
    smem.restype = ctypes.c_longlong
    with torch.inference_mode():
        for name, (k, n) in rows_gemm_shapes().items():
            w = torch.from_numpy((0.02 * rng.randn(n, k)).astype(
                np.float32)).cuda().bfloat16()
            for rows in rows_list:
                x = torch.from_numpy(rng.randn(rows, k).astype(
                    np.float32)).cuda().bfloat16()
                before = rg.LAUNCHES["rows_gemm"]
                got = rg.rows_linear(x, w)
                launched = rg.LAUNCHES["rows_gemm"] - before
                again = rg.rows_linear(x, w)
                want = rg.rows_linear_plain(x, w)
                err = (got.float() - want.float()).abs()
                key = f"{name} rows={rows}"
                worst[key] = (err / rows_gemm_bound(x, w, want)).max().item()
                p = rg.plan(rows, k, n, rg.sm_count(x.device))
                if not (launched == 1 and worst[key] <= 1
                        and got.dtype == want.dtype
                        and got.shape == want.shape
                        and torch.equal(got, again)
                        and p.smem() == smem(p.nb, p.kc, p.depth)):
                    bad.append((key, launched, worst[key], p.smem(),
                                smem(p.nb, p.kc, p.depth)))
                if rows not in timed_rows:
                    continue
                y = torch.empty((rows, n), dtype=torch.bfloat16,
                                device="cuda")
                copies = cold_copies(w.numel() * 2)
                ws = [w.clone() for _ in range(copies)]

                def kernel(wi):
                    return lambda: rg.launch(x, wi, y)

                row = {"shape": f"rows={rows} K={k} N={n} bf16",
                       "plan": list(rg.plan(rows, k, n)),
                       "max_bound_ratio": worst[key],
                       "ms": time_ms(lambda: rg.rows_linear(x, w)),
                       "device_ms": device_ms(kernel(w)),
                       "cold_ms": cold_ms(lambda i: kernel(ws[i]), copies),
                       "cold_copies": copies,
                       "plain_ms": time_ms(lambda: rg.rows_linear_plain(x, w)),
                       "library_ms": time_ms(lambda: F.linear(x, w)),
                       "library_device_ms": device_ms(lambda: F.linear(x, w)),
                       "library_cold_ms": cold_ms(
                           lambda i: lambda: F.linear(x, ws[i]), copies)}
                del ws
                row["bound_ms"], row["bound_by"] = bound(
                    rg.launch_bytes(rows, k, n), 2 * rows * k * n,
                    BF16_FLOP_PER_S)
                rows_out[key] = row
                log("rows_gemm", json.dumps(row))
    log("rows_gemm bound ratios", json.dumps(worst))
    if bad:
        raise AssertionError(f"rows_gemm against its plain version (case, "
                             f"launches, bound ratio, the plan's shared "
                             f"memory and the library's): {bad}")
    return rows_out


def rows_gemm_token_step(gpt_name="gpt2_medium", b=4, seed=9):
    """`GPT.sample` at gpt2_medium, 8 CFG rows, through the token-step
    graph two ways in one process, twice in turns: the kernel as the port
    launches it, and cuBLAS for every product (`rows_gemm.engages` off, as
    the parent ran it): median ms a token (CUDA events after each token) and
    the launches of each. Then the edges of a captured graph of two
    launches (`programmatic_edges`)."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops import rows_gemm as rg
    cfg = getattr(C, gpt_name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval()
    gpt.cuda()
    rng = np.random.RandomState(seed)
    embeds = torch.from_numpy(rng.randn(b, 77, 768).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(b, 77) > 0.3).cuda()
    kw = dict(top_k=500, top_p=0.95, cond_scale=3.0)
    engages = rg.engages
    out = {"card": nvidia_smi()}

    def sample(tag):
        gen = torch.Generator(device="cuda").manual_seed(3)
        _, res = timed_tokens(lambda on_token: gpt.sample(
            embeds, mask, generator=gen, on_token=on_token, **kw))
        out[tag] = {k: res[k] for k in ("median_ms_per_token",
                                        "ms_per_token", "launches")}

    try:
        with torch.inference_mode():
            for turn in ("a", "b"):
                sample(f"kernel_{turn}")
                rg.engages = lambda x, w: False
                sample(f"cublas_{turn}")
                rg.engages = engages
    finally:
        rg.engages = engages
    out["programmatic_edges"] = programmatic_edges()
    log("rows-gemm-token-step", json.dumps(out))
    seq = cfg.image_encoded_dim ** 2
    if (out["kernel_a"]["launches"].get("rows_gemm")
            != rows_gemm_a_token(cfg) * seq
            or out["cublas_a"]["launches"].get("rows_gemm")):
        raise AssertionError(f"rows_gemm launches in the token step: {out}")
    del gpt
    torch.cuda.empty_cache()
    return out


def programmatic_edges():
    """The edges of a captured graph of two `rows_gemm` launches by type
    (CUDA's cudaGraphGetEdges_v2 through torch's CUDA runtime), or why
    they could not be read."""
    import ctypes
    import glob
    import os
    import torch
    from favae_tpu_torch.ops import rows_gemm as rg
    x = torch.randn(8, 1536, device="cuda").bfloat16()
    w = torch.randn(1024, 1536, device="cuda").bfloat16()
    y = torch.empty(8, 1024, device="cuda", dtype=torch.bfloat16)
    rg.launch(x, w, y)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        return f"no keep_graph in this torch: {e}"
    with torch.cuda.graph(graph):
        rg.launch(x, w, y)
        rg.launch(x, w, y)
    if not hasattr(graph, "raw_cuda_graph"):
        return "no raw_cuda_graph in this torch"
    libs = sorted(glob.glob(os.path.join(os.path.dirname(torch.__file__),
                                         "..", "nvidia", "cuda_runtime",
                                         "lib", "libcudart.so*")))
    try:
        rt = ctypes.CDLL(libs[0] if libs else "libcudart.so")
        fn = rt.cudaGraphGetEdges_v2
    except (OSError, AttributeError) as e:
        return f"no cudaGraphGetEdges_v2: {e}"

    class EdgeData(ctypes.Structure):
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    if fn(raw, None, None, None, ctypes.byref(n)) != 0:
        return "cudaGraphGetEdges_v2 failed"
    frm = (ctypes.c_void_p * max(n.value, 1))()
    to = (ctypes.c_void_p * max(n.value, 1))()
    data = (EdgeData * max(n.value, 1))()
    if fn(raw, frm, to, data, ctypes.byref(n)) != 0:
        return "cudaGraphGetEdges_v2 failed"
    types = [data[i].type for i in range(n.value)]
    # 0: cudaGraphDependencyTypeDefault, 1: cudaGraphDependencyTypeProgrammatic
    return {"edges": n.value, "programmatic": types.count(1),
            "default": types.count(0)}


def rows_gemm_kernel_row(rows, launches):
    """The `kernels` line's entry for row 10, gpt2_medium's fc1 at 8 rows,
    with the launches of the serve slice's exact run."""
    return {"name": "rows_gemm", "route": "cuda",
            "source": "favae_tpu_torch/csrc/rows_gemm.cu",
            "replaces": "cuBLAS's 8-row products of the token step, which "
                        "XLA fuses (favae_tpu/models/gpt.py)",
            "launches": launches, "on_main_path": True,
            **rows["gpt2_medium.fc1 rows=8"],
            "others": {k: {f: v[f] for f in ("device_ms", "cold_ms",
                                             "library_cold_ms", "bound_ms")}
                       for k, v in rows.items()}}


def int8_kernel_checks():
    """matmul_int8 at the four CAT projection shapes, ffn_block_int8 at
    both widths and 2, 6, 8 and 16 rows (and on two streams at once),
    decode_step_fused at gpt2_medium, gpt2_mini and a ragged width; returns
    the rows that go into the `kernels` line."""
    mm = [check_matmul_int8(8, k, n, 20 + i) for i, (k, n) in enumerate(
        [(1536, 1024), (1024, 1536), (1536, 6144), (6144, 1536)])]
    # the second row tile of a block, and a ragged one
    mm += [check_matmul_int8(16, 1536, 6144, 24),
           check_matmul_int8(2, 1536, 6144, 25)]
    # every row count of 2B CFG rows up to B 8, both widths; the serve
    # slice's shape (8 rows, gpt2_large's K 1280) first
    ffn = [check_ffn_int8(rows, k, 30 + i, timed=rows == 8)
           for i, (k, rows) in enumerate(
               [(1280, 8), (1536, 8)] + [(k, r) for k in (1280, 1536)
                                         for r in (2, 6, 16)])]
    check_ffn_streams()
    step = check_decode_step()
    step["gpt2_mini"] = check_decode_step("gpt2_mini", seed=12)   # 24 heads
    # widths no preset has but the JAX gate sends to its fused kernel: a q
    # of 192 columns (its last tile half empty), rows wider than 2048
    step["ragged"] = check_decode_step(seed=13, n_embed=2304, n_head=3,
                                       n_layer=2)
    return {"matmul_int8": mm, "ffn_int8": ffn, "decode_step": step}


def int8_kernel_rows(checks, launches):
    """Entries of the `kernels` line for the three int8 kernels: numbers of
    the shape the serve slice runs most (matmul_int8, which no sampler
    calls, at the fc1 shape), launches from the serve slice's three runs."""
    rows = []
    for name, check, source, replaces in (
            ("matmul_int8", checks["matmul_int8"][2], "int8_matmul.cu",
             "favae_tpu/ops/int8_matmul.py:47"),
            ("ffn_int8", checks["ffn_int8"][0], "ffn_int8.cu",
             "favae_tpu/ops/ffn_int8.py:90"),
            ("decode_step", checks["decode_step"], "decode_step.cu",
             "favae_tpu/ops/decode_step_kernel.py:324")):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"favae_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name],
            # as in the JAX package, no sampler calls matmul_int8
            "on_main_path": name != "matmul_int8", "shape": check["shape"],
            **{f: check[f] for f in (
                "max_abs_err", "ms", "device_ms", "cold_ms", "plain_ms",
                "ms_int_pos", "device_ms_int_pos",
                "bound_ms", "bound_by", "library_ms", "library_device_ms",
                "library_cold_ms", "ms_at_pos_0", "device_ms_at_pos_0",
                "plain_ms_at_pos_0", "phases_per_layer",
                "grid_barriers_per_layer") if f in check}})
        if name == "decode_step":
            for other in ("gpt2_mini", "ragged"):
                rows[-1][other] = {f: check[other][f] for f in (
                    "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                    "device_ms_int_pos", "device_ms_at_pos_0",
                    "bound_ms")}
    return rows


def same_tree(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers equal bit for bit (each
    tensor compared on the second one's device)."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.to(b.device), b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def checking_saves(fn, events):
    """Run `fn` with every `CheckpointManager.on_epoch_end` timed (one host
    copy, then latest and, on improvement, best), `latest` read back onto
    the card (timed) and compared with the state it saved, tensor for
    tensor; one dict an event goes to `events`."""
    import torch
    from favae_tpu_torch.utils.checkpoint import (STATE_FILE,
                                                  CheckpointManager,
                                                  restore_checkpoint)
    orig = CheckpointManager.on_epoch_end

    def checked(self, epoch, score, state, is_last=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self, epoch, score, state, is_last)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, meta = restore_checkpoint(self.latest_path, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        best = pathlib.Path(self.best_path) / STATE_FILE
        events.append({
            "epoch": epoch, "meta": meta, "save_s": save_s,
            "load_s": load_s, "best_written": score == self.best_score,
            "state_pt_mib": (pathlib.Path(self.latest_path) / STATE_FILE)
            .stat().st_size / 2 ** 20,
            "best_exists": best.exists(),
            "restored_bitwise_equal": same_tree(state, back)})
        del back

    CheckpointManager.on_epoch_end = checked
    try:
        return fn()
    finally:
        CheckpointManager.on_epoch_end = orig


def train_slice(per_step_launches, recon_gn_calls, name="train", extra=()):
    """`cli.train_favae` at expe5 B=16 (`config_run`), held to phase 3's
    census: `per_step_launches` a step with and without D, one
    reconstruction's `recon_gn_calls` a val batch."""
    census = {"per_step": per_step_launches,
              "recon_gn_calls": recon_gn_calls, "init": {}}
    return config_run(name, TRAIN_ARGS + list(extra), 16, census)


def export_and_evaluate(recon_gn_calls):
    """`cli.export_torch` of the train slice's `best`, then
    `cli.eval_favae --torch_ckpt` on the `.pt` with rFID (a seeded
    pytorch-fid-layout Inception file written here) and saved
    reconstructions, counts zeroed just before and read just after; and
    `--orbax_ckpt` on the directory without Inception, which must give the
    same psnr. The Inception file has pytorch-fid's layout (its `fc`
    included), He-scaled random convolutions and fresh BatchNorm
    statistics."""
    import torch
    from favae_tpu_torch.cli import eval_favae, export_torch
    from favae_tpu_torch.models.inception import InceptionV3FID
    from favae_tpu_torch.ops import gn, vq
    run = ROOT / "output" / "chip_smoke"
    pt, recons = run / "best.pt", run / "recons"
    inc = ROOT / "output" / "pt_inception_seeded.pt"
    t0 = time.perf_counter()
    export_torch.main(["--orbax_ckpt", str(run / "best"), "--out", str(pt)])
    export_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    sd = InceptionV3FID(torch.float32).state_dict()
    for k, v in sd.items():
        if k.endswith("conv.weight"):  # He-scaled: ReLU keeps the scale
            sd[k] = torch.randn(v.shape, generator=gen) * math.sqrt(
                2.0 / v[0].numel())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    torch.save(sd, inc)
    shutil.rmtree(recons, ignore_errors=True)
    out = {"export_s": export_s, "pt_mib": pt.stat().st_size / 2 ** 20}
    for name, extra in (
            ("rfid", ["--torch_ckpt", str(pt), "--inception_ckpt", str(inc),
                      "--save_recons", str(recons)]),
            ("dir", ["--orbax_ckpt", str(run / "best")])):
        for counts in (vq.LAUNCHES, gn.LAUNCHES):
            for k in counts:
                counts[k] = 0
        m = eval_favae.main(SLICE_ARGS + extra)
        torch.cuda.synchronize()
        launches = {**vq.LAUNCHES, **gn.LAUNCHES}
        batches = len(m["batch_ms"])
        out[name] = {
            **{k: m[k] for k in m if k != "batch_ms"},
            "batch_ms": m["batch_ms"],
            "steady_ms_per_batch": statistics.median(m["batch_ms"][1:]),
            "launches": launches}
        expect = {"vq_nearest": batches, "gn_stats": batches * recon_gn_calls,
                  "gn_apply": batches * recon_gn_calls, "gn_bwd_sums": 0,
                  "gn_bwd_dx": 0}
        if launches != expect or m["images"] != 64:
            raise AssertionError(f"eval {name}: launches {launches} over "
                                 f"{m['images']} images, expected {expect}")
    pngs = sorted(p.name for p in recons.glob("*.png"))
    out.update(pngs=len(pngs),
               inception_ms_per_batch=out["rfid"]["steady_ms_per_batch"]
               - out["dir"]["steady_ms_per_batch"],
               psnr_bits_equal=out["rfid"]["psnr"] == out["dir"]["psnr"])
    log("export-eval", json.dumps(out))
    if not (math.isfinite(out["rfid"]["rfid"]) and len(pngs) == 64
            and abs(out["rfid"]["psnr"] - out["dir"]["psnr"])
            <= 1e-6 * abs(out["dir"]["psnr"])):
        raise AssertionError("export-eval: rfid not finite, PNGs missing or "
                             "the exported file evaluates otherwise")
    return out


def train_cross_check(name="expe5", configs=None, draws=None):
    """One disc-on, ffl-on step at expe5 width (or of the (model, loss,
    train) `configs`), 64 px, B=2, from one state: on the card in f32 (TF32
    off) and in bf16, and on the CPU in f32 through the plain versions;
    `draws`, the quantizer draws of the step's two stages, made once and
    given to all three."""
    import torch
    from favae_tpu_torch.config import (TrainConfig, celebahq_expe5,
                                        celebahq_expe5_losses)
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    from favae_tpu_torch.train.favae_state import FavaeTrainState
    from favae_tpu_torch.train.favae_step import make_train_step
    if configs is None:
        configs = (celebahq_expe5(), celebahq_expe5_losses(),
                   TrainConfig(batch_size=2))
    model_cfg, loss_cfg, tc = configs
    tc = dataclasses.replace(tc, batch_size=2)
    ds = SyntheticDataset(64, size=2, seed=3)
    x = torch.from_numpy(np.stack([ds.get(i) for i in range(2)]))
    lr = tc.base_lr * tc.batch_size
    runs = {}
    sd = lpips_sd = None
    for run, dtype, device in (("cpu_f32", "float32", "cpu"),
                               ("card_f32", "float32", "cuda"),
                               ("card_bf16", "bfloat16", "cuda")):
        cfg = dataclasses.replace(model_cfg, compute_dtype=dtype)
        lc = dataclasses.replace(loss_cfg, spectral_dtype=dtype)
        model = build_model(cfg, device, gaussian_kernel=lc.gaussian_kernel,
                            dsl_init_sigma=lc.dsl_init_sigma)
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(sd)
        state = FavaeTrainState.create(cfg, lc, tc, lr, model=model,
                                       lpips_state_dict=lpips_sd)
        if lpips_sd is None:
            lpips_sd = {k: v.clone() for k, v in
                        state.lpips.state_dict().items()}
        step = make_train_step(cfg, lc, tc, disc_on=True, ffl_on=True)
        t0 = time.perf_counter()
        state, m = step(state, x.to(device), None if draws is None else [
            draws_on(d, device) for d in draws])
        runs[run] = {
            "metrics": {k: float(v) for k, v in m.items() if v.dim() == 0},
            "state": {k: v.detach().float().cpu()
                      for k, v in state.model.state_dict().items()},
            "s": time.perf_counter() - t0}
        del state, model, step
    ref = runs["cpu_f32"]
    out = {"config": name, "lr": lr, "cpu_step_s": ref["s"]}
    for run_name in ("card_f32", "card_bf16"):
        run = runs[run_name]
        rel = {k: abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]),
                                                   1e-12)
               for k, v in run["metrics"].items()}
        out[run_name] = {"loss_rel_err": rel,
                         "finite": all(math.isfinite(v)
                                       for v in run["metrics"].values())}
    out["card_f32"].update(state_errors(ref["state"],
                                        runs["card_f32"]["state"], lr))
    out["metrics"] = {n: runs[n]["metrics"] for n in runs}
    f32, lim = out["card_f32"], TRAIN_XCHECK
    bf16_out = [k for k, v in runs["card_bf16"]["metrics"].items()
                if (k.startswith("loss") or k == "weight_d")
                and abs(v - ref["metrics"][k]) > max(
                    BF16_BAND["rel"] * abs(ref["metrics"][k]),
                    BF16_BAND["abs"])]
    out["card_bf16"]["outside_band"] = bf16_out
    log("train-cross-check", json.dumps(out))
    if not (f32["finite"] and out["card_bf16"]["finite"]
            and max(f32["loss_rel_err"].values()) <= lim["loss_rel"]
            and f32["state_max_rel_err"] <= lim["state_rel"]
            and f32["param_max_err_lr"] <= lim["param_max_lr"]
            and f32["param_mean_err_lr"] <= lim["param_mean_lr"]
            and not bf16_out):
        raise AssertionError(f"train cross-check {name} out of bounds "
                             f"{TRAIN_XCHECK}, bf16 band {BF16_BAND}")
    return out


def state_errors(ref, state, lr):
    """A model state_dict against a reference one (both on the CPU, f32):
    the codebook EMA and BatchNorm statistics relative to each tensor's
    largest entry, the parameters in units of `lr`."""
    import torch
    state_err, param_err = {}, []
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (v - ref[k]).abs()
        if k.startswith("quantizer.") or "running_" in k:
            state_err[k] = err.max().item() / max(ref[k].abs().max().item(),
                                                  1e-30)
        else:
            param_err.append(err.flatten() / lr)
    param_err = torch.cat(param_err)
    worst = max(state_err, key=state_err.get)
    return {"state_max_rel_err": state_err[worst], "state_worst": worst,
            "param_max_err_lr": param_err.max().item(),
            "param_mean_err_lr": param_err.mean().item()}


def resume_cross_check(steps=4, deterministic=True):
    """Two epochs of `steps` steps at expe5 width, 64 px, B=2, f32 (TF32
    off), the discriminator from the second, uninterrupted; against one
    epoch, a checkpoint, a new trainer resumed from it and the second
    epoch. With `deterministic`, cuDNN and PyTorch pick deterministic
    algorithms (cuDNN's weight gradients and the codebook's `index_add_`
    otherwise add in a varying order, and eight GAN steps amplify that
    past any bound) and the run is held to TRAIN_XCHECK; without, the
    differences are printed as the card's run-to-run noise. Whether the
    bits matched is printed."""
    import torch
    from favae_tpu_torch.config import (TrainConfig, celebahq_expe5,
                                        celebahq_expe5_losses)
    from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    cfg = dataclasses.replace(celebahq_expe5(), compute_dtype="float32")
    lc = dataclasses.replace(celebahq_expe5_losses(), spectral_dtype="float32",
                             disc_start_epochs=1, ffl_start_epochs=0)
    tc = TrainConfig(batch_size=2, epochs=2)
    root = ROOT / "output" / "chip_smoke_resume"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name):
        tr = FavaeTrainer(cfg, lc, tc, str(root / name), device="cuda")
        loader = DataLoader(SyntheticDataset(64, size=2 * steps, seed=5), 2,
                            num_workers=2, shuffle=True, seed=0)
        return tr, loader

    t0 = time.perf_counter()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        full, loader = trainer("full")
        full.fit(loader, None)
        half, loader = trainer("half")
        half.fit(loader, None, epochs=1)
        again, loader = trainer("half")
        again.resume()
        again.fit(loader, None)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)
    ref = {k: v.detach().float().cpu()
           for k, v in full.state.model.state_dict().items()}
    ours = {k: v.detach().float().cpu()
            for k, v in again.state.model.state_dict().items()}
    keys = sorted({k for h in full.history for k in h
                   if k.startswith("loss") or k == "weight_d"})
    loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(again.history, full.history[steps:])
                   for k in keys if k in b)
    out = {"deterministic": deterministic, "lr": full.lr,
           "start_epoch": again.start_epoch,
           "steps": [again.state.step, full.state.step],
           "loss_max_rel_err": loss_rel,
           **state_errors(ref, ours, full.lr),
           "bits_equal": same_tree(again.state.state_dict(),
                                   full.state.state_dict()),
           "s": time.perf_counter() - t0}
    log("resume-cross-check", json.dumps(out))
    lim = TRAIN_XCHECK
    within = (loss_rel <= lim["loss_rel"]
              and out["state_max_rel_err"] <= lim["state_rel"]
              and out["param_max_err_lr"] <= lim["param_max_lr"]
              and out["param_mean_err_lr"] <= lim["param_mean_lr"])
    if not (out["start_epoch"] == 1 and out["steps"] == [2 * steps] * 2
            and (within or not deterministic)):
        raise AssertionError(f"resume cross-check out of bounds {lim}")
    return out


def inception_cross_check(n=2):
    """InceptionV3 features of `n` 256 px images with the seeded weights of
    `export_and_evaluate`, on the card in f32 (TF32 off) and in bf16,
    against the CPU in f32; errors relative to the largest feature."""
    import torch
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.inception import (InceptionV3FID,
                                                  load_inception)
    ds = SyntheticDataset(256, size=n, seed=11)
    x = torch.from_numpy(np.stack([ds.get(i) for i in range(n)]))
    feats = {}
    for name, dtype, dev in (("cpu_f32", torch.float32, "cpu"),
                             ("card_f32", torch.float32, "cuda"),
                             ("card_bf16", torch.bfloat16, "cuda")):
        model = InceptionV3FID(dtype)
        load_inception(model, str(ROOT / "output" / "pt_inception_seeded.pt"))
        model.to(dev).eval()
        feats[name] = model(x.to(dev)).cpu()
    ref = feats["cpu_f32"]
    scale = ref.abs().max().item()
    out = {"feature_max": scale, "feature_mean": ref.mean().item()}
    for name in ("card_f32", "card_bf16"):
        err = (feats[name] - ref).abs()
        out[name] = {"max_abs_err": err.max().item(),
                     "max_rel_err_of_largest": err.max().item() / scale,
                     "finite": bool(torch.isfinite(feats[name]).all())}
    log("inception-cross-check", json.dumps(out))
    lim = INCEPTION_XCHECK
    if not (out["card_f32"]["finite"] and out["card_bf16"]["finite"]
            and out["card_f32"]["max_rel_err_of_largest"] <= lim["f32"]
            and out["card_bf16"]["max_rel_err_of_largest"] <= lim["bf16"]):
        raise AssertionError(f"inception cross-check out of bounds {lim}")
    return out


# ---------------------------------------------------------------------------
# phase 5: cross-check
# ---------------------------------------------------------------------------

def psnr_db(a, b):
    import torch
    mse = torch.mean((a - b) ** 2).item()
    return 10 * math.log10(4.0 / max(mse, 1e-30))


def cpu_reference(cpu_model, x):
    """f32 CPU reconstruction of x plus what the checks need: z_q, indices
    and the cosine score of every token against every code."""
    import torch
    from favae_tpu_torch.models.quantizer import l2norm
    with torch.inference_mode():
        z_q, idx, taps = cpu_model.encode(x)
        rec = cpu_model.decode(z_q)[0]
        z = taps[3].reshape(-1, taps[3].shape[-1]).float()
        scores = l2norm(z) @ l2norm(cpu_model.codebook_state().embed).T
    return {"rec": rec, "idx": idx, "z_q": z_q, "scores": scores}


def cross_check(name, model_gpu, x, ref):
    """A card model against the CPU f32 reference: the full reconstruction,
    the decoder alone on the reference's z_q (continuous error without code
    flips), index agreement, and how far each chosen code trails the best
    one under the reference's scores (a flip at a near-tie trails little)."""
    import torch
    rec, idx = model_gpu.reconstruct(x.cuda())
    with torch.inference_mode():
        dec = model_gpu.decode(ref["z_q"].cuda())[0]
    rec, idx, dec = rec.float().cpu(), idx.cpu(), dec.float().cpu()
    scores = ref["scores"]
    chosen = scores.gather(1, idx.reshape(-1, 1))[:, 0]
    out = {"recon_psnr_db": psnr_db(rec, ref["rec"]),
           "decode_psnr_db": psnr_db(dec, ref["rec"]),
           "index_agreement": (idx == ref["idx"]).float().mean().item(),
           "max_score_deficit": (scores.max(dim=1).values - chosen).max().item(),
           "finite": bool(torch.isfinite(rec).all())}
    log("cross-check", name, json.dumps(out))
    lo = XCHECK_BOUNDS[name]
    if not (out["finite"] and out["decode_psnr_db"] > lo["decode_psnr_db"]
            and out["index_agreement"] >= lo["index_agreement"]
            and out["max_score_deficit"] <= lo["max_score_deficit"]):
        raise AssertionError(f"cross-check {name} out of bounds {lo}")
    return out


# ---------------------------------------------------------------------------
# phase 7: the serve slice (CAT text-to-image) and its cross-check
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--prompt", "a smiling woman with glasses",
              "--prompt", "an old man with a beard", "--n", "2",
              "--top_k", "500", "--top_p", "0.95", "--cond_scale", "3",
              "--out", str(ROOT / "output" / "chip_smoke_serve.npz")]
# (name, extra flags, expected launches of decode_step, ffn_int8, add_ln
# (1 + 4 a layer a token on the exact route, add_ln_a_token; 1 + 3 on the
# FFN-only one, whose int8 block replaces gelu_ln), mqa_decode (2 a layer
# a token on both, mqa_decode_a_token) and rows_gemm (7 a layer a token on
# the exact route, rows_gemm_a_token; the 5 attention products on the
# FFN-only one))
SERVE_RUNS = (("exact", [], 0, 0, (1 + 4 * 24) * 256, 2 * 24 * 256,
               7 * 24 * 256),
              ("fused", ["--quantized"], 256, 0, 0, 0, 0),
              ("ffn_int8", ["--quantized", "--gpt_name", "gpt2_large"],
               0, 36 * 256, (1 + 3 * 36) * 256, 2 * 36 * 256, 5 * 36 * 256),
              # the yardstick of the FFN-only route: the same model, exact
              ("exact_large", ["--gpt_name", "gpt2_large"], 0, 0,
               (1 + 4 * 36) * 256, 2 * 36 * 256, 7 * 36 * 256))
# serve cross-check bounds, card against CPU at gpt2_medium width, 2 layers,
# 4x4 tokens, on CFG logits of up to 7.7. f32 (TF32 off): the two differ by
# summation order only (5.7e-6 measured on an H100). bf16 routes: both sides
# round at the same places, so logits differ by the bf16 roundings that
# flipped (0.030 fused, 0.053 FFN-only measured); free-running tokens must
# agree at 0.9, the bound the JAX package's own test of its fused kernel
# uses (0.98 and 1.0 measured).
SERVE_XCHECK = {"f32_logits": 1e-4, "bf16_logits": 0.15, "agreement": 0.9}
# the CAT train slice: steps an epoch (the steady time is the median of all
# but the first two), synthetic val batches (train_cat's 4), and the
# cross-check's bounds: expe5's (TRAIN_XCHECK) for the loss, relative, and
# the largest parameter error, in units of the learning rate; after one
# AdamW update a parameter moves by about lr whatever its gradient, so the
# mean error is held to the CPU test's 1e-3 lr as well (5.6e-7 measured on
# an H100) and the step's own token ids must be equal
CAT_STEPS = 10
CAT_VAL_BATCHES = 4
CAT_TRAIN_ARGS = ["--ds", "chip_smoke_cat", "--output_dir",
                  str(ROOT / "output"), "--synthetic_data", "--use_cosine_sim",
                  "--gpt_name", "gpt2_medium", "--batch_size", "16",
                  "--epochs", "1", "--synthetic_steps", str(CAT_STEPS),
                  "--print_steps", str(CAT_STEPS)]
CAT_XCHECK = {"loss_rel": 1e-3, "param_max_lr": 2.1, "param_mean_lr": 1e-3}


def int8_counts():
    from favae_tpu_torch.ops import decode_step_kernel, ffn_int8, int8_matmul
    return (decode_step_kernel.LAUNCHES, ffn_int8.LAUNCHES,
            int8_matmul.LAUNCHES)


def serve_counts():
    """The launch counts of the serving kernels: the int8 ones, add_ln,
    mqa_decode and rows_gemm."""
    from favae_tpu_torch.ops import ln_fused, mqa_decode, rows_gemm
    return (*int8_counts(), ln_fused.LAUNCHES, mqa_decode.LAUNCHES,
            rows_gemm.LAUNCHES)


def serve_slice():
    """`cli.generate` at cat_celebahq through its three engines, counts
    zeroed just before each run and read just after."""
    import torch
    from favae_tpu_torch.cli import generate
    from favae_tpu_torch.models.clip_text import word_pattern
    from favae_tpu_torch.ops import gn, vq
    log(f"tokenizer word pattern compiled with: {word_pattern()[1]}")
    (ROOT / "output").mkdir(exist_ok=True)
    runs, launches = {}, {}
    for (name, extra, want_step, want_ffn, want_ln, want_mqa,
         want_rows) in SERVE_RUNS:
        for counts in (vq.LAUNCHES, gn.LAUNCHES, *serve_counts()):
            for k in counts:
                counts[k] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = generate.main(SERVE_ARGS + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for counts in (gn.LAUNCHES, *serve_counts())
               for k, v in counts.items()}
        imgs, toks = out["images"], out["tokens"]
        res = {"route": out["route"], "launches": got, "card": nvidia_smi(),
               **{k: out[k] for k in (
                   "clip_ms", "prepare_ms", "first_token_ms", "ms_per_token",
                   "median_ms_per_token", "tokens_per_s", "images_per_s",
                   "decode_ms")},
               "token_steps_per_s": 1e3 / out["ms_per_token"],
               "wall_s_incl_model_build": wall,
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30,
               "images_shape": list(imgs.shape), "tokens_shape": list(toks.shape),
               "tokens_min_max": [int(toks.min()), int(toks.max())],
               "finite": bool(np.isfinite(imgs).all())}
        log("serve", name, json.dumps(res))
        if not (out["route"] == name.split("_large")[0] and imgs.shape == (4, 256, 256, 3)
                and res["finite"] and toks.shape == (4, 16, 16)
                and 0 <= toks.min() and toks.max() < 1024):
            raise AssertionError(f"serve {name}: bad images or tokens")
        if (got["decode_step"], got["ffn_int8"], got["matmul_int8"],
                got["add_ln"], got["mqa_decode"], got["rows_gemm"]) != (
                    want_step, want_ffn, 0, want_ln, want_mqa, want_rows):
            raise AssertionError(
                f"serve {name}: launches {got}, expected decode_step "
                f"{want_step}, ffn_int8 {want_ffn}, matmul_int8 0, add_ln "
                f"{want_ln}, mqa_decode {want_mqa}, rows_gemm {want_rows}")
        if not (got["gn_stats"] and got["gn_stats"] == got["gn_apply"]):
            raise AssertionError(f"serve {name}: the FA-VAE decode launched "
                                 f"GroupNorm kernels {got}")
        runs[name], launches[name] = res, got
    return runs, {"decode_step": launches["fused"]["decode_step"],
                  "ffn_int8": launches["ffn_int8"]["ffn_int8"],
                  "matmul_int8": 0, "add_ln": launches["exact"]["add_ln"],
                  "mqa_decode": launches["exact"]["mqa_decode"],
                  "rows_gemm": launches["exact"]["rows_gemm"]}


def timed_tokens(sample):
    """Call `sample(on_token)` with every kernel's count zeroed: ms of the
    first token, mean ms of the others (on a graphed route the second
    includes the capture) and their median, from CUDA events recorded
    after each token is queued, and the launches it made."""
    import torch
    from favae_tpu_torch.graphs import launch_counts
    marks = []

    def on_token(pos):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    for counts in launch_counts():
        for k in counts:
            counts[k] = 0
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    out = sample(on_token)
    torch.cuda.synchronize()
    token_ms = [a.elapsed_time(e) for a, e in zip([start] + marks, marks)]
    got = {k: v for counts in launch_counts() for k, v in counts.items() if v}
    return out, {"first_token_ms": token_ms[0],
                 "ms_per_token": statistics.mean(token_ms[1:]),
                 "median_ms_per_token": statistics.median(token_ms[1:]),
                 "total_ms": sum(token_ms), "launches": got}


def serve_sample_graph(gpt_name="gpt2_medium", b=4, seed=9):
    """At gpt2_medium (the serve slice's exact and fused routes), 8 CFG
    rows, seeded random weights and text embeddings, top-k 500, top-p 0.95,
    scale 3: `GPT.sample` through the CUDA graph of its token step with one
    seed twice and another once (`add_ln_a_token` launches of `ln_fused`'s
    kernel, `mqa_decode_a_token` of `mqa_decode`'s and `rows_gemm_a_token`
    of `rows_gemm`'s a token, every replay counted, and no other
    hand-written kernel), a CPU generator refused;
    then the fused route of `sample_tokens` through the graph, 256
    `decode_step` launches
    (`decode_replay` holds its kernel's replays against eager calls)."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.decode_engine import sample_tokens
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops.decode_step_kernel import prepare_fused_decode
    cfg = getattr(C, gpt_name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval()
    gpt.cuda()
    rng = np.random.RandomState(seed)
    embeds = torch.from_numpy(rng.randn(b, 77, 768).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(b, 77) > 0.3).cuda()
    seq = cfg.image_encoded_dim ** 2
    noise = torch.from_numpy(rng.gumbel(size=(seq, b, 1024)).astype(
        np.float32)).cuda()
    kw = dict(top_k=500, top_p=0.95, cond_scale=3.0)

    def sample(gen_seed):
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        return timed_tokens(lambda on_token: gpt.sample(
            embeds, mask, generator=gen, on_token=on_token, **kw))

    out = {"card": nvidia_smi()}
    with torch.inference_mode():
        a, out["gpt_sample_graph"] = sample(3)
        a2, second = sample(3)
        c, _ = sample(4)
        out["gpt_sample_graph_again_ms_per_token"] = second["ms_per_token"]
        try:
            gpt.sample(embeds, mask, generator=torch.Generator(), **kw)
            out["cpu_generator_refused"] = False
        except ValueError:
            out["cpu_generator_refused"] = True
        fused = prepare_fused_decode(gpt, cfg)
        tf, out["fused_graph"] = timed_tokens(
            lambda on_token: sample_tokens(
                cfg, gpt, embeds, mask, on_token=on_token, fused=fused,
                gumbel_noise=noise, **kw))
    out["same_seed_same_tokens"] = bool(torch.equal(a, a2))
    out["other_seed_other_tokens"] = not torch.equal(a, c)
    out["tokens_in_range"] = bool(0 <= int(min(a.min(), tf.min()))
                                  and int(max(a.max(), tf.max())) < 1024)
    log("serve-sample-graph", json.dumps(out))
    want = {"decode_step": seq}
    if (out["gpt_sample_graph"]["launches"]
            != {"add_ln": add_ln_a_token(cfg) * seq,
                "mqa_decode": mqa_decode_a_token(cfg) * seq,
                "rows_gemm": rows_gemm_a_token(cfg) * seq}
            or out["fused_graph"]["launches"] != want
            or not (out["same_seed_same_tokens"]
                    and out["other_seed_other_tokens"]
                    and out["tokens_in_range"]
                    and out["cpu_generator_refused"])):
        raise AssertionError(f"GPT.sample and the fused route through the "
                             f"token-step graph: {out}")
    del gpt, fused
    torch.cuda.empty_cache()
    return out


def serve_graph_routes(gpt_name="gpt2_large", b=4, seed=9):
    """`sample_tokens` at gpt2_large, 8 CFG rows, seeded random weights and
    text embeddings, top-k 500, top-p 0.95, scale 3: the exact route (the
    yardstick of the FFN-only one) and the FFN-only route, both through
    `CATBlock.decode` (rows 8 and 9) and the CUDA graph of the token step, ms a token from CUDA events after each
    token (the first apart), counts zeroed just before each run; then the
    FFN-only route twice with one seed and once with another."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                      sample_tokens)
    from favae_tpu_torch.models.gpt import GPT
    cfg = getattr(C, gpt_name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval()
    gpt.cuda()
    rng = np.random.RandomState(seed)
    embeds = torch.from_numpy(rng.randn(b, 77, 768).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(b, 77) > 0.3).cuda()
    qparams = quantize_decode_params(gpt)
    seq = cfg.image_encoded_dim ** 2

    def run(kw, gen_seed):
        grid, res = timed_tokens(lambda on_token: sample_tokens(
            cfg, gpt, embeds, mask, top_k=500, top_p=0.95, cond_scale=3.0,
            on_token=on_token,
            generator=torch.Generator(device="cuda").manual_seed(gen_seed),
            **kw))
        res["tokens_per_s"] = grid.numel() / res["total_ms"] * 1e3
        return grid, res

    out = {}
    with torch.inference_mode():
        _, out["exact_graph"] = run({}, 3)
        a, out["ffn_int8_graph"] = run({"qparams": qparams}, 3)
        b2, _ = run({"qparams": qparams}, 3)
        c, _ = run({"qparams": qparams}, 4)
    out["same_seed_same_tokens"] = bool(torch.equal(a, b2))
    out["other_seed_other_tokens"] = not torch.equal(a, c)
    out["tokens_in_range"] = bool(0 <= int(a.min()) and int(a.max()) < 1024)
    log("serve-graph", json.dumps(out))
    # both routes run CATBlock.decode: the FFN-only route without gelu_ln
    # (its feed-forward and residual are the int8 block)
    exact = {"add_ln": add_ln_a_token(cfg) * seq,
             "mqa_decode": mqa_decode_a_token(cfg) * seq,
             "rows_gemm": rows_gemm_a_token(cfg) * seq}
    want = {"ffn_int8": cfg.n_layer * seq,
            "add_ln": (1 + 3 * cfg.n_layer) * seq,
            "mqa_decode": mqa_decode_a_token(cfg) * seq,
            "rows_gemm": 5 * cfg.n_layer * seq}
    if (out["exact_graph"]["launches"] != exact
            or out["ffn_int8_graph"]["launches"] != want
            or not (out["same_seed_same_tokens"]
                    and out["other_seed_other_tokens"]
                    and out["tokens_in_range"])):
        raise AssertionError(f"serve through the token-step graph: {out}, "
                             f"expected launches {exact}, {want}")
    del gpt, qparams
    torch.cuda.empty_cache()
    return out


def serve_cross_check():
    """gpt2_medium width, 2 layers, 4x4 tokens, B=4: the same weights, text
    embeddings and injected gumbel noise on the card and on the CPU. (a) the
    exact sampler in f32; (b) the fused route, kernel against plain version;
    (c) the FFN-only route. Each: CFG logits under the CPU's tokens as
    forced context, and free-running token agreement."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                      sample_tokens)
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops.decode_step_kernel import prepare_fused_decode
    cfg = dataclasses.replace(
        C.gpt2_medium(vocab_size=1024, n_cond_embed=768), n_layer=2,
        image_encoded_dim=4)
    rng = np.random.RandomState(5)
    b, seq = 4, 16
    embeds = torch.from_numpy(rng.randn(b, 77, 768).astype(np.float32))
    mask = torch.from_numpy(rng.rand(b, 77) > 0.3)
    noise = torch.from_numpy(rng.gumbel(size=(seq, b, 1024)).astype(np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        gpt_cpu = GPT(cfg, dtype=torch.float32).eval()
    sd = gpt_cpu.state_dict()
    out = {}

    def both(name, dtype, prepare, bound):
        res = {}
        for dev in ("cpu", "cuda"):
            gpt = GPT(cfg, dtype=dtype).eval()
            gpt.load_state_dict(sd)
            gpt.to(dev)
            kw = dict(top_k=500, top_p=0.95, cond_scale=3.0,
                      gumbel_noise=noise.to(dev), return_logits=True,
                      **prepare(gpt))
            args = (cfg, gpt, embeds.to(dev), mask.to(dev))
            free, _ = sample_tokens(*args, **kw)
            forced = res["cpu"]["free"] if dev == "cuda" else free
            _, logits = sample_tokens(
                *args, forced_tokens=forced.reshape(b, -1).to(dev), **kw)
            res[dev] = {"free": free.cpu(), "logits": logits.float().cpu()}
        err = (res["cuda"]["logits"] - res["cpu"]["logits"]).abs().max().item()
        agree = (res["cuda"]["free"] == res["cpu"]["free"]).float().mean().item()
        out[name] = {"forced_logits_max_abs_err": err,
                     "logits_max": res["cpu"]["logits"].abs().max().item(),
                     "free_token_agreement": agree}
        return err <= bound and agree >= SERVE_XCHECK["agreement"], res

    ok_a, res_a = both("exact_f32", torch.float32, lambda g: {},
                       SERVE_XCHECK["f32_logits"])
    gpt32 = GPT(cfg, dtype=torch.float32).eval()
    gpt32.load_state_dict(sd)
    gpt32.cuda()
    sampled = gpt32.sample(embeds.cuda(), mask.cuda(), top_k=500, top_p=0.95,
                           cond_scale=3.0, gumbel_noise=noise.cuda()).cpu()
    out["exact_f32"]["gpt_sample_equals_engine_on_card"] = bool(
        torch.equal(sampled, res_a["cuda"]["free"]))
    out["exact_f32"]["tokens_equal_cpu"] = bool(
        torch.equal(res_a["cuda"]["free"], res_a["cpu"]["free"]))
    ok_b, _ = both("fused_bf16", torch.bfloat16,
                   lambda g: {"fused": prepare_fused_decode(g, cfg)},
                   SERVE_XCHECK["bf16_logits"])
    ok_c, _ = both("ffn_int8_bf16", torch.bfloat16,
                   lambda g: {"qparams": quantize_decode_params(g)},
                   SERVE_XCHECK["bf16_logits"])
    log("serve-cross-check", json.dumps(out))
    if not (ok_a and ok_b and ok_c
            and out["exact_f32"]["gpt_sample_equals_engine_on_card"]
            and out["exact_f32"]["tokens_equal_cpu"]):
        raise AssertionError(f"serve cross-check out of bounds {SERVE_XCHECK}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the CAT train slice and its cross-check
# ---------------------------------------------------------------------------

def zero_counts():
    from favae_tpu_torch.graphs import launch_counts
    for counts in launch_counts():
        for k in counts:
            counts[k] = 0


def cat_train_slice(decode_gn):
    """`cli.train_cat` at cat_celebahq, B=16, one epoch of CAT_STEPS steps
    and CAT_VAL_BATCHES val batches on the full pipeline, then `--resume`
    for a second epoch, then `cli.export_torch --cat` of `best` and
    `cli.generate` on the `.pt` and on the directory, then a fresh run with
    --cache_latents. Counts are zeroed just before each run and read just
    after; the steps' own launches are the counts' rise over the epoch's
    steps, less its previews'. Each run makes CAT_STEPS + CAT_VAL_BATCHES
    encodes of B=16 (in the steps and val batches, or in the precompute):
    one vq_nearest and as many gn_stats as gn_apply an encode, none in the
    cached steps, no GroupNorm backward, no int8 kernel. A preview (global
    step 0 and after validation; `--img_steps` is 1000) adds one FA-VAE
    decode's `decode_gn` GroupNorm calls, two on the cached path (the
    cached tokens' decode stands for the images), and one `GPT.sample`'s
    `add_ln` and `mqa_decode` launches. Each checkpoint is timed,
    read back and compared (`checking_saves`). Returns the runs and the
    full pipeline's launches a step."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.cli import train_cat
    from favae_tpu_torch.ops import gn, ln_fused, mqa_decode, rows_gemm, vq
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    # a preview samples once on the exact route: GPT.sample's token steps
    gpt_cfg = C.gpt2_medium(vocab_size=1024)
    per_sample_ln = add_ln_a_token(gpt_cfg) * gpt_cfg.image_encoded_dim ** 2
    per_sample_mqa = (mqa_decode_a_token(gpt_cfg)
                      * gpt_cfg.image_encoded_dim ** 2)
    per_sample_rows = (rows_gemm_a_token(gpt_cfg)
                       * gpt_cfg.image_encoded_dim ** 2)

    def rows_1_4():
        torch.cuda.synchronize()
        return {**vq.LAUNCHES, **gn.LAUNCHES}

    def rise(before):
        return {k: v - before[k] for k, v in rows_1_4().items()}

    in_steps, previews, preview_s = [], [], []
    train_epoch, log_samples = CATTrainer.train_epoch, CATTrainer._log_samples

    def counted_epoch(self, *args, **kw):
        before = rows_1_4()
        train_epoch(self, *args, **kw)
        in_steps.append(rise(before))

    def counted_preview(self, name, *args, **kw):
        before = rows_1_4()
        t0 = time.perf_counter()
        log_samples(self, name, *args, **kw)
        launched = rise(before)             # synchronises
        preview_s.append(time.perf_counter() - t0)
        previews.append((name, launched))

    run_dir = ROOT / "output" / "cat" / "chip_smoke_cat"
    shutil.rmtree(run_dir, ignore_errors=True)
    runs, per_step = {}, None
    encodes = CAT_STEPS + CAT_VAL_BATCHES
    for name, extra in (("full", []), ("resume", ["--resume", "--epochs", "2"]),
                        ("cached", ["--cache_latents"])):
        if name == "cached":
            runs["export_generate"] = cat_export_generate(run_dir)
            shutil.rmtree(run_dir)
        in_steps.clear()
        previews.clear()
        preview_s.clear()
        saves = []
        zero_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        CATTrainer.train_epoch = counted_epoch
        CATTrainer._log_samples = counted_preview
        try:
            out = checking_saves(
                lambda: train_cat.main(CAT_TRAIN_ARGS + extra), saves)
        finally:
            CATTrainer.train_epoch = train_epoch
            CATTrainer._log_samples = log_samples
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rows_1_4()
        others = {k: v for c in int8_counts() for k, v in c.items()}
        ln = ln_fused.LAUNCHES["add_ln"]
        mqa = mqa_decode.LAUNCHES["mqa_decode"]
        prods = rows_gemm.LAUNCHES["rows_gemm"]
        hist = out["history"]
        losses = [h["loss_gpt"] for h in hist]
        res = {"start_epoch": out["start_epoch"], "steps": len(hist),
               "epochs": sorted({h["epoch"] for h in hist}),
               "step_ms": [h["step_ms"] for h in hist],
               **{k: out["summary"][k] for k in (
                   "steady_ms_per_step", "samples_per_s")},
               "lr": out["lr"],
               "launches": launches, "int8_launches": others,
               "launches_in_epoch": in_steps[0] if in_steps else None,
               "previews": previews[:], "preview_s": preview_s[:],
               "precompute_s": out["precompute_s"],
               "max_memory_allocated_gib":
                   torch.cuda.max_memory_allocated() / 2 ** 30,
               "wall_s_incl_model_build": wall, "losses": losses,
               "val": out["val"], "checkpoints": saves,
               "finite": all(math.isfinite(v) for v in losses)
               and all(math.isfinite(v["loss_gpt"]) for v in out["val"])}
        log("cat-train", name, json.dumps(res))
        epoch = 1 if name == "resume" else 0
        if not (len(hist) == CAT_STEPS and res["finite"]
                and len(in_steps) == 1 and res["epochs"] == [epoch]
                and res["start_epoch"] == epoch):
            raise AssertionError(f"cat train {name}: {len(hist)} steps of "
                                 f"epochs {res['epochs']} in {len(in_steps)} "
                                 f"epochs, finite {res['finite']}")
        decodes = 2 if name == "cached" else 1
        want_previews = [("train/from-cond", decodes)] * (name != "resume") \
            + [("val/from-cond", decodes)]
        got_previews = []
        for pname, d in previews:
            if (d["vq_nearest"] or d["gn_stats"] != d["gn_apply"]
                    or d["gn_stats"] % decode_gn):
                raise AssertionError(f"cat train {name}: preview {pname} "
                                     f"launched {d}")
            got_previews.append((pname, d["gn_stats"] // decode_gn))
        in_epoch_previews = sum(d["gn_stats"] for pname, d in previews
                                if pname.startswith("train/"))
        steps = dict(in_steps[0])
        for k in ("gn_stats", "gn_apply"):
            steps[k] -= in_epoch_previews
        if name == "full":
            per_step = {k: v // CAT_STEPS for k, v in steps.items()}
        expect_steps = ({k: 0 for k in steps} if name == "cached"
                        else {k: v * CAT_STEPS for k, v in per_step.items()})
        expect = {k: v * encodes for k, v in per_step.items()}
        for k in ("gn_stats", "gn_apply"):
            expect[k] += sum(d[k] for _, d in previews)
        if not (per_step["vq_nearest"] == 1
                and per_step["gn_stats"] == per_step["gn_apply"] > 0
                and launches == expect and steps == expect_steps
                and got_previews == want_previews
                and ln == len(previews) * per_sample_ln
                and mqa == len(previews) * per_sample_mqa
                and prods == len(previews) * per_sample_rows
                and not any(launches[k] for k in ("gn_bwd_sums",
                                                  "gn_bwd_dx"))
                and not any(others.values())):
            raise AssertionError(
                f"cat train {name}: launches {launches} ({steps} in the "
                f"steps), previews {got_previews}, add_ln {ln}, mqa_decode "
                f"{mqa}, rows_gemm {prods} and {others}, expected add_ln "
                f"{per_sample_ln}, mqa_decode {per_sample_mqa} and rows_gemm "
                f"{per_sample_rows} a preview, "
                f"{expect} ({expect_steps} in the steps) and previews "
                f"{want_previews} of {decode_gn} GroupNorm calls a decode: "
                f"rows 1-3 only, the same in each of {encodes} encodes, one "
                "vq_nearest an encode")
        if not (len(saves) == 1 and saves[0]["restored_bitwise_equal"]
                and saves[0]["meta"]["epoch"] == epoch + 1):
            raise AssertionError(f"cat train {name}: checkpoints {saves}")
        runs[name] = res
    shutil.rmtree(run_dir)
    share = runs["full"]["steady_ms_per_step"] - runs["cached"][
        "steady_ms_per_step"]
    log("cat-train frozen towers", json.dumps({
        "launches_per_step_full": per_step,
        "full_minus_cached_ms": share,
        "share_of_full": share / runs["full"]["steady_ms_per_step"]}))
    return runs, per_step


def cat_export_generate(run_dir):
    """`cli.export_torch --cat` of the CAT run's `best`, then
    `cli.generate` with `--torch_cat_ckpt` on the `.pt` and with `--ckpt`
    on the directory: the same prompts and seed must give the same
    tokens."""
    import torch
    from favae_tpu_torch.cli import export_torch, generate
    pt = run_dir / "best.pt"
    t0 = time.perf_counter()
    export_torch.main(["--cat", "--orbax_ckpt", str(run_dir / "best"),
                       "--out", str(pt), "--gpt_name", "gpt2_medium"])
    out = {"export_s": time.perf_counter() - t0,
           "pt_mib": pt.stat().st_size / 2 ** 20}
    args = ["--prompt", "a smiling woman with glasses", "--n", "2",
            "--seed", "4", "--out", str(run_dir / "samples.npz")]
    toks = {}
    for name, extra in (("pt", ["--torch_cat_ckpt", str(pt)]),
                        ("dir", ["--ckpt", str(run_dir / "best")])):
        t0 = time.perf_counter()
        g = generate.main(args + extra)
        torch.cuda.synchronize()
        toks[name] = g["tokens"]
        out[name] = {"route": g["route"], "ms_per_token": g["ms_per_token"],
                     "wall_s": time.perf_counter() - t0,
                     "finite": bool(np.isfinite(g["images"]).all())}
    out["same_tokens"] = bool(np.array_equal(toks["pt"], toks["dir"]))
    log("cat-export-generate", json.dumps(out))
    if not (out["same_tokens"] and out["pt"]["finite"]
            and out["dir"]["finite"]):
        raise AssertionError("cat export: generate on the exported .pt and "
                             "on the checkpoint directory differ")
    return out


def cat_train_cross_check(b=2, seed=3):
    """One full-pipeline step at cat_celebahq with the GPT at 2 layers, f32
    everywhere (TF32 off), dropout 0 and the conditioning keep mask
    injected, from one state on the card and on the CPU (plain versions)."""
    import torch
    from favae_tpu_torch.config import cat_celebahq
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.models.txt_cond import build_cat
    from favae_tpu_torch.train.cat_step import (CATAdamW, CATTrainState,
                                                make_cat_train_step)
    base = cat_celebahq()
    cfg = dataclasses.replace(
        base, gpt=dataclasses.replace(base.gpt, n_layer=2, dropout=0.0,
                                      remat="none"),
        vqgan=dataclasses.replace(base.vqgan, compute_dtype="float32"))
    ds = SyntheticDataset(256, size=b, seed=seed, with_captions=True)
    x = torch.from_numpy(np.stack([ds.get(i)[0] for i in range(b)]))
    caps = [ds.get(i)[1] for i in range(b)]
    keep = torch.tensor([True, False][:b])
    lr = cfg.base_lr * b
    runs, sd = {}, None
    for dev in ("cpu", "cuda"):
        cat = build_cat(cfg, dev, seed=seed,
                        tokenizer=BPETokenizer(merges=["s y", "sy n"]))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            cat.gpt = GPT(cfg.gpt, dtype=torch.float32).to(dev)
        if sd is None:
            sd = {k: v.clone() for k, v in cat.gpt.state_dict().items()}
        cat.gpt.load_state_dict(sd)
        state = CATTrainState(cat=cat, opt=CATAdamW(cat.gpt, cfg),
                              lr_schedule=lambda i: lr)
        ids = cat.tokenize(caps)
        seen, encode = [], cat.encode_to_z  # the step's own token ids
        cat.encode_to_z = lambda x: seen.append(encode(x)) or seen[-1]
        t0 = time.perf_counter()
        state, m = make_cat_train_step()(
            state, x.to(dev), ids, torch.Generator(device=dev),
            cond_keep=keep.to(dev))
        if len(seen) != 1:
            raise AssertionError(f"the step encoded {len(seen)} times")
        runs[dev] = {"loss": float(m["loss_gpt"]), "z": seen[0].cpu(),
                     "s": time.perf_counter() - t0,
                     "params": {k: v.detach().float().cpu() for k, v in
                                cat.gpt.named_parameters()}}
        del cat, state
    ref, card = runs["cpu"], runs["cuda"]
    err = torch.cat([(card["params"][k] - v).abs().flatten()
                     for k, v in ref["params"].items()]) / lr
    moved = torch.cat([(v - sd[k].float().cpu()).abs().flatten()
                       for k, v in ref["params"].items()]) / lr
    out = {"lr": lr, "loss_cpu": ref["loss"], "loss_card": card["loss"],
           "loss_rel_err": abs(card["loss"] - ref["loss"]) / ref["loss"],
           "token_id_agreement": (card["z"] == ref["z"]).float().mean()
           .item(),
           "param_max_err_lr": err.max().item(),
           "param_mean_err_lr": err.mean().item(),
           "param_mean_move_lr": moved.mean().item(),
           "cpu_step_s": ref["s"], "card_step_s": card["s"]}
    log("cat-train-cross-check", json.dumps(out))
    if not (math.isfinite(card["loss"])
            and out["loss_rel_err"] <= CAT_XCHECK["loss_rel"]
            and out["param_max_err_lr"] <= CAT_XCHECK["param_max_lr"]
            and out["param_mean_err_lr"] <= CAT_XCHECK["param_mean_lr"]
            and out["token_id_agreement"] == 1.0):
        raise AssertionError(f"cat train cross-check out of bounds "
                             f"{CAT_XCHECK}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the presets never trained on the card, and the train options
# ---------------------------------------------------------------------------

PRESET_RUNS = ("ffhq_table1", "imagenet_f16", "imagenet_f4")
RUN_STEPS = 4              # synthetic train batches an epoch (val: 4)
# imagenet_f4's and imagenet_f16's published loss weights, by flags
PRESET_LOSS_FLAGS = ["--perceptual_weight", "1.0", "--disc_weight", "0.75",
                     "--codebook_weight", "1.0", "--ffl_weight", "1.0",
                     "--DSL_weight_features", "0.01", "--gaussian_kernel",
                     "3", "--dsl_init_sigma", "3.0"]
# option run A at imagenet_f4's widths, run B at imagenet_f16's
OPTION_A_FLAGS = ["--downsample_factor", "4", "--embed_dim", "3",
                  "--codebook_dim", "256", "--codebook_size", "8192",
                  "--num_groups", "3", "--use_cosine_sim",
                  "--use_same_conv_gauss", *PRESET_LOSS_FLAGS,
                  "--kmeans_init", "--threshold_ema_dead_code", "1.0",
                  "--orthogonal_reg_weight", "10",
                  "--orthogonal_reg_max_codes", "1024",
                  "--adam_mu_dtype", "bfloat16", "--loader_uint8",
                  "--loader_processes"]
OPTION_B_FLAGS = ["--downsample_factor", "16", "--embed_dim", "256",
                  "--codebook_size", "16384", "--num_groups", "32",
                  "--use_cosine_sim", "--use_same_conv_gauss",
                  *PRESET_LOSS_FLAGS, "--use_patch_discriminator",
                  "--disc_n_layers", "2", "--use_actnorm"]
ACTNORM_REL = 1e-4         # ActNorm's init against the plain statistics
KMEANS_MEAN_ERR = 1e-5     # k-means means on the card against the plain


def zero_favae_counts():
    from favae_tpu_torch.ops import gn, vq
    for counts in (vq.LAUNCHES, gn.LAUNCHES):
        for k in counts:
            counts[k] = 0


def favae_counts():
    from favae_tpu_torch.ops import gn, vq
    return {**vq.LAUNCHES, **gn.LAUNCHES}


def run_args(name, flags, batch, epochs, disc_start):
    return ["--ds", f"chip_smoke_{name}", "--output_dir",
            str(ROOT / "output"), *flags, "--batch_size", str(batch),
            "--epochs", str(epochs), "--disc_start_epochs", str(disc_start),
            "--synthetic_steps", str(RUN_STEPS), "--print_steps",
            str(RUN_STEPS), "--num_workers", "4"]


def run_census(args, batch):
    """What a run of `cli.train_favae` with `args` launches, from its own
    configs at its batch: each kernel's launches a step with and without
    the discriminator (`train_census`), a validation batch's (one
    reconstruction: 1 vq_nearest, one gn_stats and gn_apply a GroupNorm
    call) and the first-batch inits' (k-means: kmeans_iters + 1
    assignments and one encoder forward; ActNorm: one reconstruction);
    the GroupNorm shapes of the forward and the backward with their
    group counts."""
    import torch
    from favae_tpu_torch.cli import train_favae
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.train.favae_state import FavaeTrainState
    cfg, lc, tc = train_favae.config_from_args(
        train_favae.build_parser().parse_args(args))
    res = cfg.codec.resolution
    ds = SyntheticDataset(res, size=batch)
    x = torch.from_numpy(np.stack([ds.get(i) for i in range(batch)])).cuda()
    state = FavaeTrainState.create(cfg, lc, tc, tc.base_lr * batch, "cuda")
    groups = {}
    fwd, _ = gn_census(state.model, x, groups=groups)
    recon = sum(fwd.values())
    init = {"vq_nearest": 0, "gn_stats": 0, "gn_apply": 0}
    if cfg.quantizer.kmeans_init:
        enc, _ = gn_census(state.model, x, state.model.codebook_inputs)
        init["vq_nearest"] += cfg.quantizer.kmeans_iters + 1
        init["gn_stats"] += sum(enc.values())
        init["gn_apply"] += sum(enc.values())
    if cfg.discriminator.use_actnorm and cfg.discriminator.kind == "patch":
        init["vq_nearest"] += 1
        init["gn_stats"] += recon
        init["gn_apply"] += recon
    bwd, per_step = train_census(state, cfg, lc, tc, x, groups)
    del state, x
    torch.cuda.empty_cache()
    return {"configs": (cfg, lc, tc), "per_step": per_step,
            "recon_gn_calls": recon, "init": init, "fwd": fwd, "bwd": bwd,
            "groups": groups}


def expected_launches(census, hist, val_images, batch, with_init):
    per = census["per_step"]
    on = sum(h["disc_on"] for h in hist)
    keys = list(per[True])
    keys.remove("dy_copies")
    expect = {k: on * per[True][k] + (len(hist) - on) * per[False][k]
              for k in keys}
    val_batches = val_images // batch
    expect["vq_nearest"] += val_batches
    expect["gn_stats"] += val_batches * census["recon_gn_calls"]
    expect["gn_apply"] += val_batches * census["recon_gn_calls"]
    if with_init:
        for k, v in census["init"].items():
            expect[k] += v
    return expect


def config_run(name, args, batch, census, with_init=True, hook=None):
    """`cli.train_favae` with `args`, the counts zeroed just before and
    read just after and held to the census; each epoch's checkpoint read
    back and compared with the state it saved (`checking_saves`), `best`
    written. One line, `name`: steady step ms without and with D,
    images/s, peak memory, first and last losses, the codebook's batch
    usage and replacements, launches."""
    import torch
    from favae_tpu_torch.cli import train_favae
    zero_favae_counts()
    torch.cuda.reset_peak_memory_stats()
    saves = []
    t0 = time.perf_counter()
    out = checking_saves(lambda: train_favae.main(args), saves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = favae_counts()
    hist, val = out["history"], out["val"]
    val_images = sum(v["images"] for v in val)
    expect = expected_launches(census, hist, val_images, batch, with_init)
    losses = sorted({k for h in hist for k in h
                     if k.startswith("loss") or k == "weight_d"})
    finite = all(math.isfinite(h[k]) for h in hist for k in losses if k in h)

    def steady(disc_on):  # all but the first two steps of the stage
        ms = [h["step_ms"] for h in hist if h["disc_on"] == disc_on][2:]
        return statistics.median(ms) if ms else None

    res = {"batch": batch, "start_epoch": out["start_epoch"],
           "epochs": sorted({h["epoch"] for h in hist}),
           "steps_disc_off": sum(not h["disc_on"] for h in hist),
           "steps_disc_on": sum(h["disc_on"] for h in hist),
           "val_images": val_images, "val_batches": val_images // batch,
           "step_ms_disc_off": steady(False), "step_ms_disc_on": steady(True),
           "step_ms": [h["step_ms"] for h in hist],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "wall_s_incl_model_build": wall,
           "first_step": {k: hist[0][k] for k in losses if k in hist[0]},
           "last_step": {k: hist[-1][k] for k in losses if k in hist[-1]},
           "weight_d_range": [min((h["weight_d"] for h in hist
                                   if h["disc_on"]), default=None),
                              max((h["weight_d"] for h in hist
                                   if h["disc_on"]), default=None)],
           "cb_batch_usage_pct": [h["cb_batch_usage_pct"] for h in hist],
           "cb_replaced": [h.get("cb_replaced") for h in hist],
           "val": val, "all_losses_finite": finite,
           "launches": launches, "expected_launches": expect,
           "checkpoints": saves}
    for key in ("disc_off", "disc_on"):
        ms = res[f"step_ms_{key}"]
        res[f"imgs_per_s_{key}"] = batch * 1e3 / ms if ms else None
    if hook is not None:
        res.update(hook())
    log(name, json.dumps(res))
    if not finite:
        raise AssertionError(f"{name}: non-finite training losses")
    if launches != expect or not all(launches.values()):
        raise AssertionError(f"{name} launched {launches}, its census "
                             f"implies {expect}")
    if not (len(saves) == len(res["epochs"])
            and all(e["restored_bitwise_equal"] and e["best_exists"]
                    for e in saves)
            and [e["meta"]["epoch"] for e in saves] == [
                e + 1 for e in res["epochs"]]):
        raise AssertionError(f"{name}: checkpoints {saves} after epochs "
                             f"{res['epochs']}")
    return res


def fitting_batch(name, make_args, with_census):
    """The largest of 16, 8 and 4 images a batch whose census and run fit
    on the card: (batch, census, run line)."""
    import torch
    for batch in (16, 8, 4):
        try:
            census = run_census(make_args(batch), batch)
            return batch, census, with_census(batch, census)
        except torch.cuda.OutOfMemoryError as e:
            log(f"run {name}: batch {batch} does not fit ({e}); "
                "trying a smaller one")
            gc.collect()
            torch.cuda.empty_cache()
    raise AssertionError(f"run {name}: no batch of 16, 8 or 4 fits")


def write_png_manifest(root, n, res, seed, name):
    """`n` seeded RGB PNGs of `res` px under `root` and a pkl manifest."""
    import pickle
    from PIL import Image
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = root / f"{name}_{i}.png"
        Image.fromarray(rng.randint(0, 256, (res, res, 3), np.uint8)).save(p)
        paths.append(str(p))
    with open(root / f"{name}.pkl", "wb") as f:
        pickle.dump(paths, f)
    return str(root / f"{name}.pkl")


def actnorm_recorder():
    """Wrap `ActNorm.data_init` to keep, for each call, the largest error
    of the loc and scale it set against the plain per-channel statistics
    of its input recomputed in f64 on the card, relative to the largest
    entry (`ACTNORM_REL`)."""
    import torch
    from favae_tpu_torch.models.discriminator import ActNorm
    orig, rows = ActNorm.data_init, []

    def data_init(self, x, dp=None):
        out = orig(self, x, dp)
        xd = x.double()
        mean = xd.mean(dim=(0, 2, 3))
        scale = 1.0 / (xd.std(dim=(0, 2, 3)) + 1e-6)
        loc_err = (self.loc.detach().double().flatten() + mean).abs().max()
        scale_err = (self.scale.detach().double().flatten() - scale
                     ).abs().max()
        rows.append({"channels": x.shape[1], "input": list(x.shape),
                     "loc_rel_err": (loc_err / mean.abs().max()).item(),
                     "scale_rel_err": (scale_err / scale.abs().max()).item()})
        return out

    ActNorm.data_init = data_init

    def restore():
        ActNorm.data_init = orig
        return rows
    return restore


def kmeans_card_check(n, k, d, cosine, seed, iters=10):
    """k-means through row 1 (`ops.vq`) against its plain version (the JAX
    package's formulas) on the card, from one first permutation: the whole
    runs (bins exactly, means within KMEANS_MEAN_ERR), and each assignment
    step of the kernel's run held on the same means, its codes differing
    from the plain argmax only at near-ties (the chosen code's f64 score
    within VQ_NEAR_TIE of the best)."""
    import torch
    from favae_tpu_torch.models.quantizer import (code_stats, kmeans,
                                                  kmeans_assign, l2norm)
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn(k // 4, d, device="cuda", generator=g)
    x = centres[torch.randint(0, k // 4, (n,), device="cuda", generator=g)]
    x = x + 0.5 * torch.randn(n, d, device="cuda", generator=g)
    if cosine:
        x = l2norm(x)
    first = torch.randperm(n, device="cuda", generator=g)
    zero_favae_counts()
    t0 = time.perf_counter()
    means, bins = kmeans(x, k, iters, cosine, first)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = favae_counts()["vq_nearest"]
    t0 = time.perf_counter()
    pmeans, pbins = kmeans(x, k, iters, cosine, first, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the kernel's trajectory, each step's codes against the plain argmax
    flips, gap = 0, 0.0
    m = x[first[:k]]
    for it in range(iters + 1):
        kb = kmeans_assign(x, m, cosine)
        pb = kmeans_assign(x, m, cosine, plain=True)
        diff = (kb != pb).nonzero().flatten()
        flips += diff.numel()
        if diff.numel():
            xs, md = x[diff].double(), m.double()
            if cosine:
                sc = xs @ md.T
            else:
                sc = -torch.cdist(xs, md)
            gap = max(gap, (sc.max(dim=1).values
                            - sc.gather(1, kb[diff, None])[:, 0]).max().item())
        if it == iters:
            break
        b, sums = code_stats(x, kb, k)
        nm = sums / b.clamp(min=1.0)[:, None]
        if cosine:
            nm = l2norm(nm)
        m = torch.where((b == 0)[:, None], m, nm)
    row = {"shape": f"N={n} K={k} D={d} {'cosine' if cosine else 'euclidean'}"
                    f" iters={iters}",
           "vq_nearest_launches": launches,
           "bins_equal": bool(torch.equal(bins, pbins)),
           "means_max_abs_err": (means - pmeans).abs().max().item(),
           "populated_bins": int((bins > 0).sum()),
           "step_flips_vs_plain": flips, "flip_max_score_gap": gap,
           "kernel_s": kernel_s, "plain_s": plain_s}
    log("kmeans", json.dumps(row))
    whole = row["bins_equal"] and row["means_max_abs_err"] <= KMEANS_MEAN_ERR
    if launches != iters + 1 or gap > VQ_NEAR_TIE or not (whole or flips):
        raise AssertionError(f"k-means on the card disagrees: {row}")
    if not whole:
        log(f"kmeans: the whole runs part at {flips} near-tie flips "
            f"(max score gap {gap})")
    del x, means, pmeans
    torch.cuda.empty_cache()
    return row


def draws_on(draws, device):
    """QuantizerDraws with every tensor moved to `device`."""
    return dataclasses.replace(draws, **{
        f.name: (None if getattr(draws, f.name) is None
                 else getattr(draws, f.name).to(device))
        for f in dataclasses.fields(draws)})


def presets_and_options(skip_fwd=(), skip_bwd=()):
    """Phase 9: the three presets as published and option runs A and B,
    each through `cli.train_favae` held to its own census; A resumed and
    its checkpoints compared bit for bit; B's ActNorm init against the
    plain statistics; k-means on the card; one train step of each config
    on the card against the CPU; row 1 at each preset's shape and rows 2-4
    at every GroupNorm shape of these runs that is not among `skip_fwd` /
    `skip_bwd` (phase 3's, with 32 groups). Returns (runs, vq rows,
    k-means rows, (gn rows, their census), (backward rows, their
    census)), each census {shape: calls a recon batch or a train step of
    the first run that has it}."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.cli import train_favae
    from favae_tpu_torch.models.quantizer import draw_quantizer
    runs, shapes_fwd, shapes_bwd, groups = {}, {}, {}, {}

    def collect(name, census):
        for key, calls in census["fwd"].items():
            shapes_fwd.setdefault(key, (calls, name))
        for key, calls in census["bwd"].items():
            shapes_bwd.setdefault(key, (calls, name))
        groups.update(census["groups"])

    # the presets as published: both stages (D from epoch 1) and the sigma
    # group, validation after each epoch
    for preset in PRESET_RUNS:
        def make(batch, preset=preset):
            return run_args(preset, ["--preset", preset, "--synthetic_data"],
                            batch, 2, 1)
        shutil.rmtree(ROOT / "output" / f"chip_smoke_{preset}",
                      ignore_errors=True)
        batch, census, res = fitting_batch(
            preset, make, lambda b, c, make=make, preset=preset: config_run(
                f"run {preset}", make(b), b, c))
        collect(preset, census)
        runs[preset] = res
        shutil.rmtree(ROOT / "output" / f"chip_smoke_{preset}",
                      ignore_errors=True)
        torch.cuda.empty_cache()

    # A: the codebook options at imagenet_f4's widths on a PNG manifest,
    # uint8 batches from worker processes; saved, then resumed one epoch
    data = ROOT / "output" / "chip_smoke_A_data"
    train_pkl = write_png_manifest(data, 16 * RUN_STEPS, 256, 21, "train")
    val_pkl = write_png_manifest(data, 16, 256, 22, "val")
    shutil.rmtree(ROOT / "output" / "chip_smoke_A", ignore_errors=True)

    def make_a(batch, extra=()):
        return run_args("A", OPTION_A_FLAGS + [
            "--train_file", train_pkl, "--test_file", val_pkl], batch, 2,
            1) + list(extra)
    batch_a, census_a, runs["A"] = fitting_batch(
        "A", make_a, lambda b, c: config_run("run A", make_a(b), b, c))
    collect("A", census_a)
    resumed = config_run("run A-resume",
                         make_a(batch_a, ["--resume", "--epochs", "3"]),
                         batch_a, census_a, with_init=False)
    if not (resumed["start_epoch"] == 2 and resumed["epochs"] == [2]):
        raise AssertionError("run A: the resumed run did not take exactly "
                             "the third epoch")
    runs["A-resume"] = resumed
    torch.cuda.empty_cache()

    # B: ActNorm in a 2-layer PatchGAN at imagenet_f16's widths, D from
    # step 0; each ActNorm's init held to its input's statistics
    shutil.rmtree(ROOT / "output" / "chip_smoke_B", ignore_errors=True)

    def make_b(batch):
        return run_args("B", OPTION_B_FLAGS + ["--synthetic_data"], batch,
                        1, 0)

    def run_b(batch, census):
        restore = actnorm_recorder()
        try:
            return config_run("run B", make_b(batch), batch, census,
                              hook=lambda: {"actnorm": restore()})
        finally:
            restore()
    batch_b, census_b, runs["B"] = fitting_batch("B", make_b, run_b)
    collect("B", census_b)
    act = runs["B"]["actnorm"]
    if not (len(act) == 2 and all(
            r["loc_rel_err"] <= ACTNORM_REL and r["scale_rel_err"]
            <= ACTNORM_REL for r in act)):
        raise AssertionError(f"run B: ActNorm init {act}, bound "
                             f"{ACTNORM_REL}")
    torch.cuda.empty_cache()

    # k-means on the card at A's first batch, and euclidean where the
    # plain version's (N, K, D) difference fits
    kms = [kmeans_card_check(batch_a * 64 * 64, 8192, 256, True, 31),
           kmeans_card_check(4096, 1024, 256, False, 32)]

    # one train step of each config on the card against the CPU
    for preset in PRESET_RUNS:
        losses = {"ffhq_table1": C.ffhq_table1_losses,
                  "imagenet_f16": C.imagenet_f16_losses,
                  "imagenet_f4": C.imagenet_f4_losses}[preset]()
        train_cross_check(preset, (C.PRESETS[preset](), losses,
                                   C.TrainConfig()))
    for name, census in (("A", census_a), ("B", census_b)):
        cfg, lc, tc = census["configs"]
        draws = None
        if name == "A":  # 2 images at 64 px: 2 x 16 x 16 tokens
            gen = torch.Generator().manual_seed(41)
            draws = [draw_quantizer(cfg.quantizer, 512, gen)
                     for _ in range(2)]
        train_cross_check(name, (cfg, lc, tc), draws)
    torch.cuda.empty_cache()

    # row 1 at each preset's shape, rows 2-4 at the new GroupNorm shapes
    vq_rows = [check_vq(4096, 2048, 256, "cosine", 61),
               check_vq(4096, 16384, 256, "cosine", 62),
               check_vq(65536, 8192, 256, "cosine", 63)]
    fwd_keys = [k for k in shapes_fwd
                if not (k in skip_fwd and groups[k] == 32)]
    bwd_keys = [k for k in shapes_bwd
                if not (k in skip_bwd and groups[k] == 32)]
    gn_rows = [check_gn(k, 300 + i, groups[k]) for i, k in
               enumerate(fwd_keys)]
    bwd_rows = [check_gn_bwd(k, 400 + i, groups[k]) for i, k in
                enumerate(bwd_keys)]
    return (runs, vq_rows, kms, (gn_rows, {k: shapes_fwd[k][0]
                                           for k in fwd_keys}),
            (bwd_rows, {k: shapes_bwd[k][0] for k in bwd_keys}))


def phase9_kernel_rows(vq_rows, gn_part, bwd_part, launches):
    """The `kernels` line's entries of phase 9: row 1 at each preset's
    shape, and rows 2-4 summed over phase 9's new GroupNorm shapes, each
    weighted by its calls in the first run that has it (a recon batch for
    the forward, a train step for the backward); `launches` are phase 9's
    runs' together."""
    rows = []
    for r in vq_rows:
        rows.append({
            "name": "vq_nearest", "route": "cuda",
            "source": "favae_tpu_torch/csrc/vq_nearest.cu",
            "replaces": "favae_tpu/ops/vq_pallas.py:65",
            "launches": launches["vq_nearest"], "phase": 9,
            **{f: r[f] for f in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_f32_fma_ms", "library_ms",
                "library_device_ms")}})
    gn_rows, census = gn_part
    for name, part, replaces in (
            ("gn_stats", "stats", "favae_tpu/ops/gn_pallas.py:137"),
            ("gn_apply", "apply", "favae_tpu/ops/gn_pallas.py:178")):
        if not gn_rows:
            continue
        rows.append({
            "name": name, "route": "triton",
            "source": "favae_tpu_torch/ops/gn.py", "replaces": replaces,
            "launches": launches[name], "phase": 9,
            "shape": f"{sum(census.values())} calls over {len(census)} new "
                     "shapes of phase 9's runs",
            "max_abs_err": max(r[part]["max_abs_err"] for r in gn_rows),
            **{f: weighted(gn_rows, census, part, f)
               for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes",
            "library_ms": weighted(gn_rows, census, "group_norm_act",
                                   "library_ms")})
    bwd_rows, bcensus = bwd_part
    if bwd_rows:
        lib = weighted(bwd_rows, bcensus, "backward", "library_ms")
        for name, part, err, route, source, replaces in (
                ("gn_bwd_sums", "sums", "max_rel_err", "cuda",
                 "favae_tpu_torch/csrc/gn_bwd_sums.cu",
                 "favae_tpu/ops/gn_pallas.py:89"),
                ("gn_bwd_dx", "dx", "max_abs_err", "triton",
                 "favae_tpu_torch/ops/gn.py",
                 "favae_tpu/ops/gn_pallas.py:109")):
            rows.append({
                "name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "phase": 9,
                "shape": f"{sum(bcensus.values())} calls over "
                         f"{len(bcensus)} new shapes of phase 9's runs",
                "max_abs_err": max(r[part][err] for r in bwd_rows),
                **{f: weighted(bwd_rows, bcensus, part, f)
                   for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes", "library_ms": lib})
    return rows


# ---------------------------------------------------------------------------
# phase 10: distribution (ranks of torch.distributed.run), CLIP vision
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 420       # a torchrun launch; a dead or hung rank fails it
DIST_STEPS = 2             # synthetic train steps an epoch (FA-VAE: 2 epochs)
CAT_DIST_STEPS = 4         # synthetic CAT train steps (1 epoch)
FAVAE_DIST_ARGS = ["--output_dir", str(ROOT / "output"), "--synthetic_data",
                   "--epochs", "2", "--disc_start_epochs", "1",
                   "--synthetic_steps", str(DIST_STEPS), "--print_steps", "2",
                   "--num_workers", "4", "--save_every_epoch", "0"]
CAT_DIST_ARGS = ["--output_dir", str(ROOT / "output"), "--synthetic_data",
                 "--use_cosine_sim", "--gpt_name", "gpt2_medium",
                 "--epochs", "1", "--synthetic_steps", str(CAT_DIST_STEPS),
                 "--print_steps", str(CAT_DIST_STEPS), "--img_steps", "0",
                 "--num_workers", "4", "--dropout", "0"]
# CLIP vision towers on the card (f32, TF32 off) against the CPU, relative
# to the largest feature, as INCEPTION_XCHECK's f32
CLIP_VISION_XCHECK = 1e-4


def tensor_digest(tree):
    """One int a tensor of a nested dict / list (bit patterns weighted by
    position and summed on the tensor's device): equal digests are equal
    bits, between processes too."""
    import torch
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().reshape(-1)
            if t.dtype == torch.bool:
                t = t.to(torch.uint8)
            view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()]
            v = t.view(view).long()
            w = torch.arange(v.numel(), device=v.device) % 65521 + 1
            out.append(int((v * w).sum()) ^ (int(v.sum()) << 1))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
    walk(tree)
    return out


class ConcatShards:
    """The global batches of a data-parallel run for one process: each
    step the shard loaders' batches concatenated in rank order."""

    def __init__(self, loaders):
        self.loaders = loaders

    def __len__(self):
        return len(self.loaders[0])

    def set_epoch(self, epoch):
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield np.concatenate(parts)


def shard_loaders(ds, batch, world, shuffle, seed=0):
    from favae_tpu_torch.data.pipeline import DataLoader
    return ConcatShards([DataLoader(ds, batch, num_workers=2, shuffle=shuffle,
                                    seed=seed, shard_index=i,
                                    shard_count=world) for i in range(world)])


def set_deterministic(on):
    import torch
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def capturing(cls, step_attr):
    """Patch `cls.fit` to keep the trainer and count each train step's
    collectives (`parallel.mesh.STATS`): (box, undo)."""
    from favae_tpu_torch.parallel.mesh import STATS
    orig, box = cls.fit, {"steps": []}

    def counted(fn):
        def step(*a, **kw):
            before = dict(STATS)
            out = fn(*a, **kw)
            box["steps"].append({k: STATS[k] - before[k] for k in STATS})
            return out
        return step

    def fit(self, *a, **kw):
        box["trainer"] = self
        steps = getattr(self, step_attr)
        if isinstance(steps, dict):
            for k in steps:
                steps[k] = counted(steps[k])
        else:
            setattr(self, step_attr, counted(steps))
        out = orig(self, *a, **kw)
        if box.get("gather"):
            box["state"] = self.state_dict()
        return out

    cls.fit = fit
    return box, lambda: setattr(cls, "fit", orig)


def f32_gpt_build(layers):
    """`txt_cond.build_cat` with the GPT cut to `layers` and computing in
    f32 (the same seeded weights): (undo)."""
    import torch
    from favae_tpu_torch.models import txt_cond
    from favae_tpu_torch.models.gpt import GPT
    orig = txt_cond.build_cat

    def build(cfg, device=None, seed=0, tokenizer=None):
        cfg = dataclasses.replace(cfg, gpt=dataclasses.replace(
            cfg.gpt, n_layer=layers))
        cat = orig(cfg, device, seed, tokenizer)
        gpt = GPT(cfg.gpt, dtype=torch.float32)
        gpt.load_state_dict(cat.gpt.state_dict())
        cat.gpt = gpt.to(device).eval()
        return cat

    txt_cond.build_cat = build
    return lambda: setattr(txt_cond, "build_cat", orig)


def cat_layers_cfg(argv, layers):
    from favae_tpu_torch.cli import train_cat
    cfg = train_cat.config_from_args(train_cat.build_parser().parse_args(argv))
    return dataclasses.replace(cfg, gpt=dataclasses.replace(
        cfg.gpt, n_layer=layers))


def run_dist_job(job):
    """One job of a rank (or of the parent with no process group): a train
    CLI (`favae_cli`, `cat_cli`) or the FA-VAE trainer at f32 64 px
    (`favae_f32`), with its launches, collectives, memory and state
    digests."""
    import torch
    from favae_tpu_torch.graphs import launch_counts
    from favae_tpu_torch.parallel.mesh import is_main_process
    from favae_tpu_torch.parallel.sharding import gpt_param_spec
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    zero_counts()
    set_deterministic(job.get("deterministic", False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cat = job["kind"] == "cat_cli"
    box, undo = capturing(CATTrainer if cat else FavaeTrainer,
                          "train_step" if cat else "_steps")
    box["gather"] = job.get("gather", False)
    undo_build = f32_gpt_build(job["layers"]) if job.get("layers") else None
    log_samples = CATTrainer._log_samples
    if not job.get("previews", True):
        CATTrainer._log_samples = lambda self, *a, **kw: None
    t0 = time.perf_counter()
    try:
        if job["kind"] == "favae_cli":
            from favae_tpu_torch.cli import train_favae
            out = train_favae.main(job["argv"])
        elif cat:
            from favae_tpu_torch.cli import train_cat
            cfg = (cat_layers_cfg(job["argv"], job["layers"])
                   if job.get("layers") else None)
            out = train_cat.main(job["argv"], cfg=cfg)
        else:
            out = favae_f32_run(job)
        torch.cuda.synchronize()
    finally:
        undo()
        CATTrainer._log_samples = log_samples
        if undo_build is not None:
            undo_build()
        set_deterministic(False)
    wall = time.perf_counter() - t0
    tr = box["trainer"]
    dev = tr.device
    counts = {k: v for c in launch_counts() for k, v in c.items()}
    res = {"kind": job["kind"], "name": job["name"], "lr": out["lr"],
           "history": out["history"], "val": out["val"],
           "launches": counts, "collectives_a_step": box["steps"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "wall_s_incl_build": wall, "device": str(dev),
           "world": tr.mesh.world if tr.mesh is not None else 1}
    if cat:  # this rank's slices; the replicated part is every rank's
        gpt = tr.cat.gpt.state_dict()
        res["state_digest"] = tensor_digest(
            {"gpt": gpt, "opt": tr.state.opt.state_dict(),
             "generator": tr.generator.get_state()})
        res["replicated_digest"] = tensor_digest(
            {k: v for k, v in gpt.items() if gpt_param_spec(k) is None})
        if "state" in box and is_main_process():
            res["gathered_digest"] = tensor_digest(box["state"])
    else:
        res["state_digest"] = tensor_digest(tr.state.state_dict())
        if job.get("save_model") and is_main_process():
            torch.save({k: v.detach().float().cpu() for k, v in
                        tr.state.model.state_dict().items()},
                       job["save_model"])
    del box, tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def favae_f32_configs(batch, dtype="float32"):
    from favae_tpu_torch.config import (TrainConfig, celebahq_expe5,
                                        celebahq_expe5_losses)
    cfg = dataclasses.replace(celebahq_expe5(), compute_dtype=dtype)
    lc = dataclasses.replace(celebahq_expe5_losses(), spectral_dtype=dtype,
                             disc_start_epochs=1, ffl_start_epochs=0)
    return cfg, lc, TrainConfig(batch_size=batch, epochs=2,
                                save_every_epoch=0)


def favae_f32_run(job):
    """The FA-VAE trainer at expe5 width in f32, 64 px, `job["batch"]` a
    rank, two epochs of DIST_STEPS (D in the second), no validation: data
    parallel under a process group (a rank's shard), else on the
    concatenated shards of `job["world"]` ranks (the same global
    batches)."""
    from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
    from favae_tpu_torch.parallel.mesh import start_rank
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    world, batch = job["world"], job["batch"]
    device, mesh = start_rank(job["device"], job.get("backend"))
    ds = SyntheticDataset(64, size=DIST_STEPS * batch * world, seed=5)
    if mesh is not None:
        loader = DataLoader(ds, batch, num_workers=2, shuffle=True,
                            shard_index=mesh.dp.rank, shard_count=world)
        cfg, lc, tc = favae_f32_configs(batch)
    else:
        loader = shard_loaders(ds, batch, world, shuffle=True)
        if job.get("reverse_shards"):  # the same batches, rows permuted
            loader.loaders.reverse()
        cfg, lc, tc = favae_f32_configs(batch * world)
    tr = FavaeTrainer(cfg, lc, tc, str(ROOT / "output" / job["name"]),
                      device=device, mesh=mesh)
    tr.fit(loader, None)
    return {"lr": tr.lr, "history": tr.history, "val": tr.val}


def favae_single_steps(job):
    """One FA-VAE train step without D and one with it, each from the
    seeded initial state, on one global batch of `job["world"]` x
    `job["batch"]` images at `job["res"]` px in `job["dtype"]`, under
    deterministic algorithms: this rank's rows under a process group, the
    whole batch without one. The metrics of each, and the model after
    each in `save_model` + the gate (f32, rank 0)."""
    import torch
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.parallel.mesh import is_main_process, start_rank
    from favae_tpu_torch.train.favae_trainer import FavaeTrainer
    world, batch = job["world"], job["batch"]
    device, mesh = start_rank(job["device"], job.get("backend"))
    ds = SyntheticDataset(job["res"], size=world * batch, seed=6)
    x = np.stack([ds.get(i) for i in range(world * batch)])
    if mesh is not None:
        x = x[mesh.dp.rank * batch:(mesh.dp.rank + 1) * batch]
    cfg, lc, tc = favae_f32_configs(batch if mesh else batch * world,
                                    job["dtype"])
    out = []
    zero_counts()
    set_deterministic(True)
    try:
        for disc_on in (False, True):
            tr = FavaeTrainer(cfg, lc, tc, str(ROOT / "output" / job["name"]),
                              device=device, mesh=mesh)
            tr.state, m = tr._steps[(disc_on, True)](
                tr.state, torch.from_numpy(x).to(device))
            out.append({k: float(v) for k, v in m.items() if v.dim() == 0})
            if job.get("save_model") and is_main_process():
                torch.save({k: v.detach().float().cpu() for k, v in
                            tr.state.model.state_dict().items()},
                           f"{job['save_model']}.{int(disc_on)}")
            del tr
            torch.cuda.empty_cache()
    finally:
        set_deterministic(False)
    from favae_tpu_torch.graphs import launch_counts
    world_now = mesh.world if mesh is not None else 1
    return {"kind": job["kind"], "name": job["name"], "metrics": out,
            "lr": tc.base_lr * tc.batch_size * world_now,
            "launches": {k: v for c in launch_counts() for k, v in c.items()}}


def rank_main(spec_path):
    """The body of a rank under torch.distributed.run: its jobs in order,
    each rank's results saved beside the spec."""
    import os

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(pathlib.Path(spec_path).read_text())
    if spec.get("probe"):  # two ranks of one NCCL communicator on one card
        from favae_tpu_torch.parallel.mesh import start_rank
        start_rank(spec["device"], spec["backend"])
        t = torch.ones(4, device=spec["device"])
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {dist.get_rank()}: all_reduce gave {t.tolist()}",
              flush=True)
        dist.destroy_process_group()
        return 0
    results = [favae_single_steps(job) if job["kind"] == "favae_single"
               else run_dist_job(job) for job in spec["jobs"]]
    torch.save(results, f"{spec['out']}.rank{os.environ['RANK']}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def torchrun_start(nproc, spec, name):
    """Start `python -m torch.distributed.run --nproc_per_node nproc
    chip_smoke.py --rank-jobs spec` in a process group of its own."""
    import os
    import socket
    out_dir = ROOT / "output" / "chip_smoke_dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = {**spec, "out": str(out_dir / name)}
    spec_path = out_dir / f"{name}.json"
    spec_path.write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "127.0.0.1", "--master_port",
           str(port), str(ROOT / "chip_smoke.py"), "--rank-jobs",
           str(spec_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2",
                                 "PYTHONPATH": str(ROOT)})
    return {"proc": proc, "nproc": nproc, "spec": spec, "name": name,
            "t0": time.perf_counter()}


def torchrun_wait(run, timeout=DIST_TIMEOUT_S, expect_ok=True):
    """Wait for a `torchrun_start` launch, killing its process group at
    `timeout`: (rc, output). A rank that dies, hangs or exits non-zero
    makes torchrun exit non-zero, which fails the phase unless
    `expect_ok` is false."""
    import os
    import signal
    proc, name = run["proc"], run["name"]
    try:
        output, _ = proc.communicate(
            timeout=max(1.0, timeout - (time.perf_counter() - run["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        output, _ = proc.communicate()
        raise AssertionError(f"torchrun {name}: a rank hung past {timeout} s;"
                             f" killed\n{output[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    (ROOT / "output" / "chip_smoke_dist" / f"{name}.log").write_text(output)
    log(f"torchrun {name}: {run['nproc']} ranks, rc {proc.returncode}, "
        f"{time.perf_counter() - run['t0']:.1f} s")
    if proc.returncode != 0 and expect_ok:
        raise AssertionError(f"torchrun {name} exited {proc.returncode}\n"
                             f"{output[-6000:]}")
    return proc.returncode, output


def torchrun(nproc, spec, name):
    """A launch of `nproc` ranks, waited for: (rc, output, each rank's
    results)."""
    import torch
    run = torchrun_start(nproc, spec, name)
    rc, output = torchrun_wait(run)
    ranks = [torch.load(f"{run['spec']['out']}.rank{r}.pt",
                        weights_only=False) for r in range(nproc)]
    return rc, output, ranks


def dist_line(name, res, census=None):
    """The printed line of a run: steady ms a step, peak GiB, bytes and host
    seconds of collectives a train step, launches against the census."""
    hist = res["history"]
    ms = [h["step_ms"] for h in hist]
    colls = res["collectives_a_step"]
    line = {"world": res["world"], "device": res["device"], "lr": res["lr"],
            "steps": len(hist), "step_ms": ms,
            "steady_ms_per_step": statistics.median(ms[1:]) if len(ms) > 1
            else None,
            "max_memory_allocated_gib": res["max_memory_allocated_gib"],
            "collective_calls_a_step": statistics.median(
                c["calls"] for c in colls) if colls else 0,
            "collective_bytes_a_step": statistics.median(
                c["bytes"] for c in colls) if colls else 0,
            "collective_host_s_a_step": statistics.median(
                c["host_s"] for c in colls) if colls else 0.0,
            "wall_s_incl_build": res["wall_s_incl_build"],
            "launches": {k: v for k, v in res["launches"].items() if v}}
    if census is not None:
        line["expected_launches"] = census
    log("dist", name, json.dumps(line))
    return line


def favae_census(step_launches, gn_calls, res, batch):
    """What a rank of an FA-VAE run launches: its steps with and without D
    and its share of the validation batches (the val rows count the
    global images)."""
    census = {"per_step": step_launches, "recon_gn_calls": gn_calls,
              "init": {}}
    val_batches = sum(v["images"] for v in res["val"]) // (
        res["world"] * batch)
    return expected_launches(census, res["history"], val_batches, 1, False)


def cat_census(per_step, decode_gn, steps, val_batches, previews):
    expect = {k: v * (steps + val_batches) for k, v in per_step.items()}
    for k in ("gn_stats", "gn_apply"):
        expect[k] += previews * decode_gn
    return expect


def held_to(name, res, expect, failed):
    rows = {k: res["launches"].get(k, 0) for k in expect}
    if rows != expect:
        failed.append(f"{name} launched {rows}, its census implies {expect}")


def loss_keys(hist):
    return sorted({k for h in hist for k in h
                   if k.startswith("loss") or k == "weight_d"})


def band_errors(ours, ref):
    """Each loss of each step: (largest relative error, whether every one
    is within BF16_BAND relative or absolute)."""
    worst, ok = 0.0, True
    for a, b in zip(ours, ref):
        for k in loss_keys([b]):
            err = abs(a[k] - b[k])
            rel = err / max(abs(b[k]), 1e-12)
            worst = max(worst, rel)
            ok &= (math.isfinite(a[k])
                   and (rel <= BF16_BAND["rel"] or err <= BF16_BAND["abs"]))
    return worst, ok


def clip_vision_check(failed, b=4, seed=12):
    """ViT-L/14 and RN50 vision towers (seeded random weights) at 224 px,
    batch `b`, f32 with TF32 off on the card against the CPU: error
    relative to the largest feature."""
    import torch
    from favae_tpu_torch.config import CLIPResNetConfig, CLIPVisionConfig
    from favae_tpu_torch.models.clip_vision import (CLIPModifiedResNet,
                                                    CLIPVisionTransformer)
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        b, 224, 224, 3).astype(np.float32))
    out = {}
    for name, make in (("vit-l-14", lambda: CLIPVisionTransformer(
            CLIPVisionConfig())), ("rn50", lambda: CLIPModifiedResNet(
                CLIPResNetConfig()))):
        torch.manual_seed(seed)
        model = make().eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = model(x)
            ref = ref[0] if isinstance(ref, tuple) else ref
            cpu_s = time.perf_counter() - t0
            model.cuda()
            t0 = time.perf_counter()
            got = model(x.cuda())
            got = (got[0] if isinstance(got, tuple) else got).cpu()
            card_s = time.perf_counter() - t0
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        out[name] = {"shape": list(got.shape), "rel_err": err,
                     "cpu_s": cpu_s, "card_s_first_call": card_s}
        del model
    log("clip-vision-cross-check", json.dumps(out))
    if not all(v["rel_err"] <= CLIP_VISION_XCHECK for v in out.values()):
        failed.append(f"CLIP vision towers out of bounds {CLIP_VISION_XCHECK}")
    return out


def two_rank_jobs(tag, device, backend):
    """The jobs of (c) and (d) for two ranks on `device` over `backend`."""
    out = ROOT / "output" / "chip_smoke_dist"
    flags = ["--dist_backend", backend, "--device", device]
    cat_f32 = ["--ds", f"chip_smoke_dist_d32{tag}", *CAT_DIST_ARGS]
    cat_full = ["--ds", f"chip_smoke_dist_d{tag}", "--save_every_epoch", "0",
                *CAT_DIST_ARGS]
    single = dict(kind="favae_single", world=2, device=device,
                  backend=backend)
    return [
        {**single, "name": f"c1_f32{tag}", "batch": 2, "res": 64,
         "dtype": "float32", "save_model": str(out / f"c1_f32{tag}")},
        {**single, "name": f"c1_bf16{tag}", "batch": 8, "res": 256,
         "dtype": "bfloat16"},
        {"kind": "favae_f32", "name": f"c_f32{tag}", "world": 2, "batch": 2,
         "device": device, "backend": backend, "deterministic": True},
        {"kind": "favae_cli", "name": f"c_bf16{tag}", "batch": 8, "argv": [
            "--ds", f"chip_smoke_dist_c{tag}", "--preset", "celebahq_expe5",
            "--batch_size", "8", *FAVAE_DIST_ARGS, *flags]},
        {"kind": "cat_cli", "name": f"d_f32{tag}", "layers": 2, "gather": True,
         "argv": cat_f32 + ["--batch_size", "8", "--tp", "2", *flags]},
        {"kind": "cat_cli", "name": f"d_bf16{tag}", "previews": False,
         "argv": cat_full + ["--batch_size", "8", "--tp", "2", *flags]}]


def single_step_errors(job, ours, ref):
    """(c)'s single steps against one process: each gate's losses, and in
    f32 the model (TRAIN_XCHECK); in bf16 the losses (BF16_BAND)."""
    import torch
    if job["dtype"] != "float32":
        worst, ok = band_errors(ours["metrics"], ref["metrics"])
        return {"loss_max_rel_err": worst}, ok
    res, ok, lim = {}, True, TRAIN_XCHECK
    for gate, (a, b) in enumerate(zip(ours["metrics"], ref["metrics"])):
        keys = loss_keys([b])
        rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys)
        err = state_errors(
            torch.load(f"{ref['save_model']}.{gate}", weights_only=True),
            torch.load(f"{job['save_model']}.{gate}", weights_only=True),
            ref["lr"])
        res[f"disc_{'on' if gate else 'off'}"] = {"loss_max_rel_err": rel,
                                                  **err}
        ok &= (rel <= lim["loss_rel"]
               and err["state_max_rel_err"] <= lim["state_rel"]
               and err["param_max_err_lr"] <= lim["param_max_lr"]
               and err["param_mean_err_lr"] <= lim["param_mean_lr"])
    return res, ok


def multi_step_errors(ours, ref):
    """The largest relative loss difference over a run's steps."""
    keys = loss_keys(ref["history"])
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
               for a, b in zip(ours["history"], ref["history"])
               for k in keys if k in b)


def check_two_ranks(ranks, jobs, census, refs, failed):
    """Each job of a two-rank launch against its one-process reference.
    Held: (c)'s single steps (f32 within TRAIN_XCHECK, bf16 within
    BF16_BAND); every 4-step run's launches against its census on both
    ranks and the ranks' states (dp: the whole state; tp: the replicated
    part) equal bit for bit; (d)'s runs (f32 within CAT_XCHECK, its
    checkpoint resumed at tp=1 equal to the gathered state; bf16 within
    BF16_BAND). Printed, not held: how far (c)'s 4-step runs drift from
    one process, beside the drift of one process from itself with the
    rows of each batch permuted (the GAN amplifies summation-order
    differences, as the default-algorithm resume check shows). Failures
    go to `failed`."""
    out = {}
    for j, job in enumerate(jobs):
        r0, r1 = ranks[0][j], ranks[1][j]
        name = job["name"]
        ref = refs[name.split("-")[0]]
        if job["kind"] == "favae_single":
            res, ok = single_step_errors(job, r0, ref)
            res["ranks_metrics_equal"] = r0["metrics"] == r1["metrics"]
            ok &= res["ranks_metrics_equal"]
        else:
            expect = census(job, r0)
            lines = [dist_line(f"({name}) rank {r}", rr, expect)
                     for r, rr in enumerate((r0, r1))]
            for rr in (r0, r1):
                held_to(f"({name})", rr, expect, failed)
            key = ("replicated_digest" if job["kind"] == "cat_cli"
                   else "state_digest")
            res = {"ranks": lines, f"{key}_equal": r0[key] == r1[key]}
            ok = res[f"{key}_equal"]
            if job.get("layers"):
                rel = max(abs(a["loss_gpt"] - b["loss_gpt"]) / b["loss_gpt"]
                          for a, b in zip(r0["history"], ref["history"]))
                res.update(loss_max_rel_err=rel, **ref["resume"](r0, job))
                ok &= (rel <= CAT_XCHECK["loss_rel"]
                       and res["resumed_at_tp1_epoch"] == 1
                       and res["resumed_equals_gathered_bit_for_bit"])
            elif job["kind"] == "cat_cli":
                worst, within = band_errors(r0["history"], ref["history"])
                res["loss_max_rel_err"] = worst
                ok &= within
            else:  # (c)'s 4-step runs: printed
                res["drift_loss_max_rel"] = multi_step_errors(r0, ref)
                if "perm" in ref:
                    res["one_process_permuted_drift_loss_max_rel"] = \
                        multi_step_errors(ref["perm"], ref)
        res["held_within_bounds"] = ok
        log(f"dist ({name}) vs one process", json.dumps(
            {k: v for k, v in res.items() if k != "ranks"}))
        if not ok:
            failed.append(f"({name}) against one process: "
                          f"{ {k: v for k, v in res.items() if k != 'ranks'} }")
        out[name] = res
    return out


def distribution(step_launches, gn_calls, cat_per_step, decode_gn):
    """Phase 10: the trainers under torch.distributed.run.

    (a) + (b): world 1 over NCCL through `cli.train_favae` (expe5, B=16,
    256 px, bf16, 2 steps without D and 2 with) and `cli.train_cat`
    (cat_celebahq, B=16, full pipeline, 4 steps, dropout 0), under
    deterministic algorithms, held bit for bit (losses and a digest of the
    whole state) against the same runs in this process with no group.
    (c) + (d): two ranks on the one card over gloo: the FA-VAE trainer at
    f32 64 px, 2 images a rank, against this process at 4 on the same
    global batches (TRAIN_XCHECK, both deterministic); `cli.train_favae`
    at bf16 256 px, 8 a rank, against (a)'s one-process run on the same
    samples (BF16_BAND); `cli.train_cat --tp 2` at 8 a rank (a dp group of
    16) with the GPT at 2 layers in f32 against `--tp 1` at 16
    (CAT_XCHECK), validating and previewing through the split blocks and
    saving, its checkpoint resumed here at tp=1 and held bit for bit to
    the gathered state; then at full depth against (b)'s one-process run
    (BF16_BAND; validation without a preview). Every rank's launches equal
    its run's census; dp ranks end with one state and tp ranks with one
    replicated part, bit for bit. (e): (c) and (d) again over NCCL with
    one card a rank where the machine has two; NCCL's answer to two ranks
    on one card. Then the CLIP vision towers. Every check is logged before
    the first failure is raised."""
    import torch
    from favae_tpu_torch.train.cat_trainer import CATTrainer
    out, failed, launches0 = {}, [], {}

    def add_launches(res):
        for k, v in res["launches"].items():
            launches0[k] = launches0.get(k, 0) + v

    def census(job, res):
        if job["kind"] == "cat_cli":
            return cat_census(cat_per_step, decode_gn, CAT_DIST_STEPS,
                              CAT_VAL_BATCHES, job.get("previews", True))
        return favae_census(step_launches, gn_calls, res, job["batch"])

    # (a), (b): world 1 over NCCL, then the same runs here without a group
    favae_argv = ["--ds", "chip_smoke_dist_a", "--preset", "celebahq_expe5",
                  "--batch_size", "16", *FAVAE_DIST_ARGS]
    cat_argv = ["--ds", "chip_smoke_dist_b", "--batch_size", "16",
                "--save_every_epoch", "0", *CAT_DIST_ARGS]
    jobs_a = [{"kind": "favae_cli", "name": "a", "argv": favae_argv,
               "batch": 16, "deterministic": True},
              {"kind": "cat_cli", "name": "b", "argv": cat_argv,
               "deterministic": True, "previews": False}]
    _, _, ranks = torchrun(1, {"jobs": jobs_a}, "world1_nccl")
    refs = {}
    for res, job in zip(ranks[0], jobs_a):
        add_launches(res)
        name = job["name"]
        ref = refs[name] = run_dist_job(job)
        expect = census(job, res)
        out[name] = dist_line(f"({name}) world 1 nccl", res, expect)
        dist_line(f"({name}) one process", ref)
        held_to(f"({name})", res, expect, failed)
        keys = loss_keys(ref["history"])
        same = (all(a[k] == b[k] for a, b in zip(res["history"],
                                                  ref["history"])
                    for k in keys)
                and res["state_digest"] == ref["state_digest"])
        log(f"dist ({name}) bits", json.dumps({
            "losses_and_state_bit_for_bit": same,
            "steps": len(res["history"]), "loss_keys": keys}))
        if not same:
            failed.append(f"({name}): world 1 under NCCL differs from the "
                          "run without a group")
    del ranks
    torch.cuda.empty_cache()

    # NCCL's answer to two ranks on one card, while this process runs the
    # one-process references of (c) and (d)
    probe = torchrun_start(2, {"probe": True, "device": "cuda:0",
                               "backend": "nccl"}, "nccl_one_card")
    try:
        ref_dir = ROOT / "output" / "chip_smoke_dist"
        ref_dir.mkdir(parents=True, exist_ok=True)
        for job in two_rank_jobs("", "cuda", "gloo")[:2]:
            ref = {**job, "name": job["name"] + "_ref"}
            if "save_model" in ref:
                ref["save_model"] += "_ref"
            refs[job["name"]] = {**favae_single_steps(ref),
                                 "save_model": ref.get("save_model")}
        c4 = {"kind": "favae_f32", "name": "c_f32_ref", "world": 2, "batch": 2,
              "device": "cuda", "deterministic": True}
        refs["c_f32"] = run_dist_job(c4)
        refs["c_f32"]["perm"] = run_dist_job({**c4, "name": "c_f32_perm",
                                              "reverse_shards": True})
        refs["c_bf16"], refs["d_bf16"] = refs["a"], refs["b"]
        argv = ["--ds", "chip_smoke_dist_d32_ref", "--batch_size", "16",
                "--save_every_epoch", "0", *CAT_DIST_ARGS]
        refs["d_f32"] = run_dist_job({"kind": "cat_cli", "name": "d_f32_ref",
                                      "argv": argv, "layers": 2})

        def resume_at_tp1(res, job):
            """The tp=2 run's checkpoint resumed by one process at tp=1."""
            cfg = cat_layers_cfg(argv, 2)
            undo = f32_gpt_build(2)
            try:
                from favae_tpu_torch.models import txt_cond
                from favae_tpu_torch.models.clip_text import BPETokenizer
                cat = txt_cond.build_cat(cfg, "cuda", tokenizer=BPETokenizer(
                    merges=["s y", "sy n", "syn t"]))
            finally:
                undo()
            run_dir = ROOT / "output" / "cat" / job["argv"][1]
            tr = CATTrainer(cfg, str(run_dir), steps_per_epoch=CAT_DIST_STEPS,
                            batch_size=16, device="cuda", cat=cat)
            tr.resume()
            got = {"resumed_at_tp1_epoch": tr.start_epoch,
                   "resumed_equals_gathered_bit_for_bit":
                       tensor_digest(tr.state_dict()) == res["gathered_digest"]}
            del tr, cat
            shutil.rmtree(run_dir, ignore_errors=True)
            torch.cuda.empty_cache()
            return got
        refs["d_f32"]["resume"] = resume_at_tp1
    finally:
        rc, text = torchrun_wait(probe, timeout=180, expect_ok=False)
    answer = [ln for ln in text.splitlines()
              if "ncclInvalidUsage" in ln or "Duplicate GPU" in ln
              or "all_reduce gave" in ln or "Error" in ln][:6]
    log("dist nccl two ranks on one card", json.dumps(
        {"rc": rc, "answer": answer}))
    out["nccl_two_ranks_one_card"] = {"rc": rc, "answer": answer}
    torch.cuda.empty_cache()

    # (c), (d): two ranks on one card over gloo
    jobs = two_rank_jobs("", "cuda:0", "gloo")
    for job in jobs:
        if job["kind"] == "cat_cli":
            shutil.rmtree(ROOT / "output" / "cat" / job["argv"][1],
                          ignore_errors=True)
    _, _, ranks = torchrun(2, {"jobs": jobs}, "two_ranks_gloo")
    for res in ranks[0]:
        add_launches(res)
    out.update(check_two_ranks(ranks, jobs, census, refs, failed))
    del ranks

    # (e): NCCL, one card a rank, where there are two cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        jobs = two_rank_jobs("-nccl", "cuda", "nccl")
        for job in jobs:
            if job["kind"] == "cat_cli":
                shutil.rmtree(ROOT / "output" / "cat" / job["argv"][1],
                              ignore_errors=True)
        _, _, ranks = torchrun(2, {"jobs": jobs}, "two_cards_nccl")
        out.update(check_two_ranks(ranks, jobs, census, refs, failed))
        del ranks
    else:
        log(f"dist (e) not run: NCCL with one card a rank needs two cards, "
            f"this machine has {n_cards}; not counted as a pass")

    out["clip_vision"] = clip_vision_check(failed)
    out["launches_rank0"] = launches0
    if failed:
        raise AssertionError("phase 10: " + "; ".join(map(str, failed)))
    return out


def main():
    smi = nvidia_smi()
    log(smi)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import favae_tpu_torch
    pkg = pathlib.Path(favae_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"favae_tpu_torch imported from {pkg}, not from "
                           f"this checkout {ROOT}")
    from favae_tpu_torch import _build
    from favae_tpu_torch.cli import eval_favae
    from favae_tpu_torch.config import (TrainConfig, celebahq_expe5,
                                        celebahq_expe5_losses)
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    from favae_tpu_torch.ops import gn, vq
    from favae_tpu_torch.train.favae_state import FavaeTrainState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        "allow_tf32 matmul=False cudnn=False")

    free = shutil.disk_usage(ROOT).free / 2 ** 30
    log(f"disk free under the checkout: {free:.1f} GiB")
    phase_s = {}

    # phase 2: build
    t0 = t_phase = time.perf_counter()
    libs = _build.build_all()
    import triton
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s; "
        f"triton {triton.__version__}")
    for stem in libs:
        log(_build.build_log(stem).strip())
    log("launch_floor_ms", json.dumps(launch_floor_ms()))

    phase_s["2_build"] = time.perf_counter() - t_phase

    # phase 3: kernels at the shapes expe5 gives them
    t_phase = time.perf_counter()
    cfg = celebahq_expe5()
    model = build_model(cfg, "cuda", seed=0)
    ds = SyntheticDataset(256, size=64)
    x16 = torch.from_numpy(np.stack([ds.get(i) for i in range(16)])).cuda()
    t0 = time.perf_counter()
    census, not_cl = gn_census(model, x16)
    log(f"gn census (first recon, Triton compiles included "
        f"{time.perf_counter() - t0:.1f} s): {sum(census.values())} calls, "
        f"{len(census)} shapes, {not_cl} inputs not channels_last")
    vq_rows = [check_vq(4096, 1024, 256, "cosine", 1),
               check_vq(4096, 1024, 256, "euclidean", 2),
               check_vq(4096, 16384, 256, "cosine", 3)]
    check_vq_ties()
    check_vq_streams()
    gn_rows = [check_gn(key, i) for i, key in enumerate(census)]
    check_gn((2, 3, 64, 64, "silu", "bfloat16", "bfloat16"), 50, groups=3)

    loss_cfg, train_cfg = celebahq_expe5_losses(), TrainConfig(batch_size=16)
    state = FavaeTrainState.create(
        cfg, loss_cfg, train_cfg, train_cfg.base_lr * 16, "cuda")
    t0 = time.perf_counter()
    bwd_census, step_launches = train_census(
        state, cfg, loss_cfg, train_cfg, x16)
    del state
    log("train gn census " + json.dumps({
        "s_incl_compiles": time.perf_counter() - t0,
        "backward_calls_per_step": sum(bwd_census.values()),
        "backward_shapes": [list(k) + [v] for k, v in bwd_census.items()],
        "launches_per_step": {"disc_on": step_launches[True],
                              "disc_off": step_launches[False]}}))
    check_gn_bwd_layout()
    bwd_rows = [check_gn_bwd(key, 100 + i)
                for i, key in enumerate(bwd_census)]
    for i, (key, groups) in enumerate(GN_BWD_EXTRA):
        check_gn_bwd(key, 200 + i, groups)
    torch.cuda.empty_cache()
    int8_checks = int8_kernel_checks()
    ln_rows = check_add_ln()
    mqa_rows = check_mqa_decode()
    rows_gemm_rows = check_rows_gemm()

    phase_s["3_kernels"] = time.perf_counter() - t_phase

    # phase 4: the recon slice through its entry point
    t_phase = time.perf_counter()
    for counts in (vq.LAUNCHES, gn.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = eval_favae.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recon_launches = {**vq.LAUNCHES, **gn.LAUNCHES}
    batches = len(metrics["batch_ms"])
    gn_calls = sum(census.values())
    steady = statistics.median(metrics["batch_ms"][1:])
    slice_out = {
        "metrics": {k: metrics[k] for k in ("psnr", "l1", "codebook_usage",
                                            "images")},
        "launches": recon_launches, "batches": batches,
        "gn_calls_per_batch": gn_calls, "batch_ms": metrics["batch_ms"],
        "steady_ms_per_batch": steady, "imgs_per_s": 16e3 / steady,
        "wall_s_incl_model_build": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("slice", json.dumps(slice_out))
    if not all(math.isfinite(metrics[k]) for k in ("psnr", "l1")):
        raise AssertionError("non-finite reconstruction metrics")
    if metrics["images"] != 64 or recon_launches["vq_nearest"] != batches:
        raise AssertionError(f"vq_nearest launched "
                             f"{recon_launches['vq_nearest']} times over "
                             f"{batches} batches")
    if not recon_launches["gn_stats"] == recon_launches["gn_apply"] \
            == batches * gn_calls:
        raise AssertionError(f"GroupNorm kernels launched {recon_launches} "
                             f"times, expected {batches * gn_calls} each")
    if any(recon_launches[k] for k in ("gn_bwd_sums", "gn_bwd_dx")):
        raise AssertionError("the reconstruction launched backward kernels")

    with torch.inference_mode():
        recon_ms = time_ms(lambda: model.reconstruct(x16), iters=10)
    log("recon", json.dumps({"device_ms_per_batch": recon_ms,
                             "imgs_per_s": 16e3 / recon_ms}))

    phase_s["4_recon"] = time.perf_counter() - t_phase

    # phase 5: the train slice through its entry point: two epochs saving
    # latest and best, a third resumed from latest, then the export of best
    # and its evaluation with rFID and saved reconstructions
    t_phase = time.perf_counter()
    shutil.rmtree(ROOT / "output" / "chip_smoke", ignore_errors=True)
    train = train_slice(step_launches, gn_calls)
    resumed = train_slice(step_launches, gn_calls, "train-resume",
                          ["--resume", "--epochs", "3"])
    if not (resumed["start_epoch"] == 2 and resumed["epochs"] == [2]
            and resumed["steps_disc_on"] == train["steps_disc_on"]
            and resumed["steps_disc_off"] == 0):
        raise AssertionError("the resumed train run did not take exactly "
                             "the third epoch")
    torch.cuda.empty_cache()
    export_and_evaluate(gn_calls)
    torch.cuda.empty_cache()
    phase_s["5_train_save_resume_export_eval"] = time.perf_counter() - t_phase

    # phase 6: cross-checks against the CPU in f32 through the plain versions
    t_phase = time.perf_counter()
    x2 = x16[:2].cpu()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    sd = model.state_dict()
    cpu_model = build_model(cfg32, "cpu")
    cpu_model.load_state_dict(sd)
    t0 = time.perf_counter()
    ref = cpu_reference(cpu_model, x2)
    log(f"cpu f32 reconstruction of 2 images: {time.perf_counter() - t0:.1f} s")
    gpu32 = build_model(cfg32, "cuda")
    gpu32.load_state_dict(sd)
    cross_check("bf16", model, x2, ref)
    cross_check("f32", gpu32, x2, ref)
    del cpu_model, gpu32
    train_cross_check()
    del model
    torch.cuda.empty_cache()
    resume_cross_check(deterministic=False)
    resume_cross_check()
    inception_cross_check()
    torch.cuda.empty_cache()
    phase_s["6_cross_checks"] = time.perf_counter() - t_phase

    # phase 7: the serve slice through its entry point, and its cross-check
    t_phase = time.perf_counter()
    serve_runs, serve_launches = serve_slice()
    torch.cuda.empty_cache()
    serve_sample_graph()
    serve_graph_routes()
    rows_gemm_token_step()
    serve_cross_check()
    phase_s["7_serve"] = time.perf_counter() - t_phase

    # phase 8: the CAT train slice through its entry point (save, resume,
    # export, previews), and its cross-check
    t_phase = time.perf_counter()
    _, cat_step_launches = cat_train_slice(
        serve_runs["exact"]["launches"]["gn_stats"])
    torch.cuda.empty_cache()
    cat_train_cross_check()
    phase_s["8_cat_train"] = time.perf_counter() - t_phase

    # phase 9: the presets never trained on the card and the train options
    t_phase = time.perf_counter()
    runs9, vq9, _, gn9, bwd9 = presets_and_options(census, bwd_census)
    launches9 = {k: sum(r["launches"][k] for r in runs9.values())
                 for k in train["launches"]}
    phase_s["9_presets_and_options"] = time.perf_counter() - t_phase
    log("phase 9 seconds", json.dumps(
        {"s": phase_s["9_presets_and_options"], "launches": launches9}))

    # phase 10: distribution, and the CLIP vision towers
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist10 = distribution(step_launches, gn_calls, cat_step_launches,
                          serve_runs["exact"]["launches"]["gn_stats"])
    phase_s["10_distribution"] = time.perf_counter() - t_phase
    log("phase 10 seconds", json.dumps({"s": phase_s["10_distribution"]}))
    log("phase_seconds", json.dumps(phase_s))

    # the whole GroupNorm (stats + fold + apply) beside one-call PyTorch
    gn_total = {f: weighted(gn_rows, census, "group_norm_act", f)
                for f in ("ms", "device_ms", "plain_ms", "library_ms",
                          "library_device_ms", "bound_ms")}
    bwd_total = {f: weighted(bwd_rows, bwd_census, "backward", f)
                 for f in ("ms", "library_ms", "bound_ms")}
    bwd_total.update({f"fwd_bwd_{f}": weighted(bwd_rows, bwd_census,
                                               "fwd_bwd", f)
                      for f in ("ms", "library_ms")})
    log(json.dumps({"kernels": kernel_rows(
        vq_rows[0], gn_rows, census, bwd_rows, bwd_census,
        train["launches"], recon_launches, cat_step_launches)
        + int8_kernel_rows(int8_checks, serve_launches)
        + [add_ln_kernel_row(ln_rows, serve_launches["add_ln"]),
           mqa_decode_kernel_row(mqa_rows, serve_launches["mqa_decode"]),
           rows_gemm_kernel_row(rows_gemm_rows, serve_launches["rows_gemm"])]
        + phase9_kernel_rows(vq9, gn9, bwd9, launches9),
        "group_norm_act_per_batch": gn_total,
        "phase10_launches_rank0": dist10["launches_rank0"],
        "group_norm_act_backward_per_train_step": bwd_total}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-jobs"]:  # a rank started by phase 10
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
