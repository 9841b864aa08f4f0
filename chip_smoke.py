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
   and depth over 256 positions);
4. recon slice: `favae_tpu_torch.cli.eval_favae` at celebahq_expe5, batch
   16, 256 px, bf16, seeded random weights, with the kernels' launch counts
   zeroed just before and read just after;
5. train slice: `favae_tpu_torch.cli.train_favae` at celebahq_expe5, batch
   16, 256 px, bf16, two epochs of 64 synthetic batches (the discriminator
   from the second) plus validation, counts zeroed just before and read
   just after and held to what the census implies;
6. cross-checks: the same weights reconstructing 2 images, and taking one
   train step on 2 images at 64 px, on the card (bf16, and f32 with TF32
   off) and on the CPU in f32 through the plain versions;
7. serve slice: `favae_tpu_torch.cli.generate` at cat_celebahq, 2 prompts x
   2 images, seeded random weights, through its three engines (exact bf16,
   `--quantized` on the whole-step kernel, `--quantized --gpt_name
   gpt2_large` on the int8 FFN kernel, whose token step runs as a CUDA
   graph with launches counted per replay), counts
   zeroed before and read after each; `sample_tokens` at gpt2_large
   through the graph on its exact route (the FFN-only route's yardstick)
   and its FFN-only route, one seed twice and another once; then the same
   weights, text embeddings and gumbel noise through each engine on the
   card and on the CPU at 2 layers.
It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. TF32 is off for matmuls and cuDNN.
"""

import dataclasses
import json
import math
import pathlib
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
              "--print_steps", "16"]
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


def gn_census(model, x):
    """Distinct GroupNorm calls of one reconstruction: {key: calls}, with
    key = (N, C, H, W, act, in dtype, out dtype)."""
    import torch
    from favae_tpu_torch.models.blocks import GroupNormAct
    seen, not_cl = {}, [0]

    def hook(mod, args):
        t = args[0]
        key = (*t.shape, mod.act, str(t.dtype).split(".")[1],
               str(mod.dtype).split(".")[1])
        seen[key] = seen.get(key, 0) + 1
        not_cl[0] += not t.is_contiguous(memory_format=torch.channels_last)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, GroupNormAct)]
    try:
        model.reconstruct(x)
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
                recon_launches):
    """The `kernels` line: one entry per kernel. `launches` are the train
    slice's (every kernel runs there), `launches_recon` the recon slice's.
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
            "shape": f"{sum(bwd_census.values())} calls over "
                     f"{len(bwd_census)} shapes, per train step",
            "max_abs_err": max(r[part][err] for r in bwd_rows),
            "max_abs_err_is": "relative to the summed magnitudes"
                              if part == "sums" else "absolute",
            **{f: weighted(bwd_rows, bwd_census, part, f)
               for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": lib})
    return rows


def train_census(state, model_cfg, loss_cfg, train_cfg, x):
    """One train step with the discriminator and one without, at the train
    slice's shapes: the distinct GroupNorm backward calls, keyed (N, C, H,
    W, act, x dtype, dy dtype) with their calls a step, how many incoming
    gradients were not channels_last (copied by the backward), and each
    kernel's launches a step."""
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
    """Device kernels that one call of `fn` runs, from torch.profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


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
    parent_kernels = backward_kernels(parent_ops) + 2

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
            or differ or kernels > 3):
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


def check_decode_step(gpt_name="gpt2_medium", rows=8, m_cross=78, seed=11,
                      check_at=(0, 1, 128, 255), **widths):
    """The whole-step kernel at full width and depth with seeded random
    weights (`widths` replaces fields of the preset): 256 positions in order
    on one cache; at `check_at` the plain version takes the same inputs and
    a copy of the cache as it stood."""
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
                           "finite": bool(torch.isfinite(x_new.float()).all())}
            if not (ok and row_ok and untouched and checks[pos]["finite"]):
                raise AssertionError(f"decode_step_fused at pos {pos}: "
                                     f"{checks[pos]}")
        pos = seq - 1
        args = (cross_kv, cross_bias, rel_all[pos].contiguous(), fused, cfg)
        ms = time_ms(lambda: dk.decode_step_fused(xs[pos], pos, caches, *args))
        ms_first = time_ms(lambda: dk.decode_step_fused(xs[0], 0, caches,
                                                        *args))
        # a step streams all of the model's int8 weights (more than the L2
        # holds), so its device time is its cold time
        dev_ms = device_ms(lambda: dk.decode_step_fused(xs[pos], pos, caches,
                                                        *args), calls=10)
        dev_ms_first = device_ms(lambda: dk.decode_step_fused(
            xs[0], 0, caches, *args), calls=10)
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
                "bound_ms", "bound_by", "library_ms", "library_device_ms",
                "library_cold_ms", "ms_at_pos_0", "device_ms_at_pos_0",
                "plain_ms_at_pos_0", "phases_per_layer",
                "grid_barriers_per_layer") if f in check}})
        if name == "decode_step":
            for other in ("gpt2_mini", "ragged"):
                rows[-1][other] = {f: check[other][f] for f in (
                    "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                    "device_ms_at_pos_0", "bound_ms")}
    return rows


def train_slice(per_step_launches, recon_gn_calls):
    """`cli.train_favae` at expe5 B=16 with the counts zeroed just before;
    the launches must equal what the census implies."""
    import torch
    from favae_tpu_torch.cli import train_favae
    from favae_tpu_torch.ops import gn, vq
    for counts in (vq.LAUNCHES, gn.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_favae.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**vq.LAUNCHES, **gn.LAUNCHES}
    hist, val = out["history"], out["val"]
    steps_on = sum(h["disc_on"] for h in hist)
    steps_off = len(hist) - steps_on
    val_batches = sum(v["images"] for v in val) // 16
    expect = {k: steps_on * per_step_launches[True][k]
              + steps_off * per_step_launches[False][k]
              for k in launches}
    expect["vq_nearest"] += val_batches
    expect["gn_stats"] += val_batches * recon_gn_calls
    expect["gn_apply"] += val_batches * recon_gn_calls

    def steady(disc_on):  # all but the first two steps of the epoch
        ms = [h["step_ms"] for h in hist if h["disc_on"] == disc_on][2:]
        return statistics.median(ms)

    losses = sorted({k for h in hist for k in h
                     if k.startswith("loss") or k == "weight_d"})
    finite = all(math.isfinite(h[k]) for h in hist for k in losses if k in h)
    res = {
        "steps_disc_off": steps_off, "steps_disc_on": steps_on,
        "val_batches": val_batches, "launches": launches,
        "expected_launches": expect,
        "step_ms_disc_off": steady(False), "step_ms_disc_on": steady(True),
        "imgs_per_s_disc_off": 16e3 / steady(False),
        "imgs_per_s_disc_on": 16e3 / steady(True),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "wall_s_incl_model_build": wall,
        "first_step": {k: hist[0][k] for k in losses if k in hist[0]},
        "last_step": {k: hist[-1][k] for k in losses if k in hist[-1]},
        "weight_d_range": [min(h["weight_d"] for h in hist if h["disc_on"]),
                           max(h["weight_d"] for h in hist if h["disc_on"])],
        "val": val, "all_losses_finite": finite}
    log("train", json.dumps(res))
    if not finite:
        raise AssertionError("non-finite training losses")
    if launches != expect or not all(launches.values()):
        raise AssertionError(f"train slice launched {launches}, the census "
                             f"implies {expect}")
    return res


def train_cross_check():
    """One disc-on, ffl-on step at expe5 width, 64 px, B=2, from one state:
    on the card in f32 (TF32 off) and in bf16, and on the CPU in f32 through
    the plain versions."""
    import torch
    from favae_tpu_torch.config import (TrainConfig, celebahq_expe5,
                                        celebahq_expe5_losses)
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    from favae_tpu_torch.train.favae_state import FavaeTrainState
    from favae_tpu_torch.train.favae_step import make_train_step
    ds = SyntheticDataset(64, size=2, seed=3)
    x = torch.from_numpy(np.stack([ds.get(i) for i in range(2)]))
    tc = TrainConfig(batch_size=2)
    lr = tc.base_lr * tc.batch_size
    runs = {}
    sd = lpips_sd = None
    for name, dtype, device in (("cpu_f32", "float32", "cpu"),
                                ("card_f32", "float32", "cuda"),
                                ("card_bf16", "bfloat16", "cuda")):
        cfg = dataclasses.replace(celebahq_expe5(), compute_dtype=dtype)
        lc = dataclasses.replace(celebahq_expe5_losses(),
                                 spectral_dtype=dtype)
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
        state, m = step(state, x.to(device))
        runs[name] = {
            "metrics": {k: float(v) for k, v in m.items() if v.dim() == 0},
            "state": {k: v.detach().float().cpu()
                      for k, v in state.model.state_dict().items()},
            "s": time.perf_counter() - t0}
    ref = runs["cpu_f32"]
    out = {"lr": lr, "cpu_step_s": ref["s"]}
    for name in ("card_f32", "card_bf16"):
        run = runs[name]
        rel = {k: abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]),
                                                   1e-12)
               for k, v in run["metrics"].items()}
        out[name] = {"loss_rel_err": rel,
                     "finite": all(math.isfinite(v)
                                   for v in run["metrics"].values())}
    state_err, param_err = {}, []
    for k, v in runs["card_f32"]["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        r = ref["state"][k]
        err = (v - r).abs()
        if k.startswith("quantizer.") or "running_" in k:
            # relative to the tensor's largest entry
            state_err[k] = err.max().item() / max(r.abs().max().item(), 1e-30)
        else:
            param_err.append(err.flatten() / lr)
    param_err = torch.cat(param_err)
    worst = max(state_err, key=state_err.get)
    out["card_f32"].update(
        state_max_rel_err=state_err[worst], state_worst=worst,
        param_max_err_lr=param_err.max().item(),
        param_mean_err_lr=param_err.mean().item())
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
        raise AssertionError(f"train cross-check out of bounds "
                             f"{TRAIN_XCHECK}, bf16 band {BF16_BAND}")
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
# (name, extra flags, expected launches of decode_step and ffn_int8)
SERVE_RUNS = (("exact", [], 0, 0),
              ("fused", ["--quantized"], 256, 0),
              ("ffn_int8", ["--quantized", "--gpt_name", "gpt2_large"],
               0, 36 * 256),
              # the yardstick of the FFN-only route: the same model, exact
              ("exact_large", ["--gpt_name", "gpt2_large"], 0, 0))
# serve cross-check bounds, card against CPU at gpt2_medium width, 2 layers,
# 4x4 tokens, on CFG logits of up to 7.7. f32 (TF32 off): the two differ by
# summation order only (5.7e-6 measured on an H100). bf16 routes: both sides
# round at the same places, so logits differ by the bf16 roundings that
# flipped (0.030 fused, 0.053 FFN-only measured); free-running tokens must
# agree at 0.9, the bound the JAX package's own test of its fused kernel
# uses (0.98 and 1.0 measured).
SERVE_XCHECK = {"f32_logits": 1e-4, "bf16_logits": 0.15, "agreement": 0.9}


def int8_counts():
    from favae_tpu_torch.ops import decode_step_kernel, ffn_int8, int8_matmul
    return (decode_step_kernel.LAUNCHES, ffn_int8.LAUNCHES,
            int8_matmul.LAUNCHES)


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
    for name, extra, want_step, want_ffn in SERVE_RUNS:
        for counts in (vq.LAUNCHES, gn.LAUNCHES, *int8_counts()):
            for k in counts:
                counts[k] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = generate.main(SERVE_ARGS + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for counts in (gn.LAUNCHES, *int8_counts())
               for k, v in counts.items()}
        imgs, toks = out["images"], out["tokens"]
        res = {"route": out["route"], "launches": got,
               **{k: out[k] for k in (
                   "clip_ms", "prepare_ms", "first_token_ms", "ms_per_token",
                   "tokens_per_s", "images_per_s", "decode_ms")},
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
        if (got["decode_step"], got["ffn_int8"], got["matmul_int8"]) != (
                want_step, want_ffn, 0):
            raise AssertionError(
                f"serve {name}: launches {got}, expected decode_step "
                f"{want_step}, ffn_int8 {want_ffn}, matmul_int8 0")
        if not (got["gn_stats"] and got["gn_stats"] == got["gn_apply"]):
            raise AssertionError(f"serve {name}: the FA-VAE decode launched "
                                 f"GroupNorm kernels {got}")
        runs[name], launches[name] = res, got
    return runs, {"decode_step": launches["fused"]["decode_step"],
                  "ffn_int8": launches["ffn_int8"]["ffn_int8"],
                  "matmul_int8": 0}


def serve_graph_routes(gpt_name="gpt2_large", b=4, seed=9):
    """`sample_tokens` at gpt2_large, 8 CFG rows, seeded random weights and
    text embeddings, top-k 500, top-p 0.95, scale 3: the exact route (the
    yardstick of the FFN-only one) and the FFN-only route, both through the
    CUDA graph of the token step, ms a token from CUDA events after each
    token (the first apart), counts zeroed just before each run; then the
    FFN-only route twice with one seed and once with another."""
    import torch
    from favae_tpu_torch import config as C
    from favae_tpu_torch.graphs import launch_counts
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
        grid = sample_tokens(
            cfg, gpt, embeds, mask, top_k=500, top_p=0.95, cond_scale=3.0,
            dtype=torch.bfloat16, on_token=on_token,
            generator=torch.Generator(device="cuda").manual_seed(gen_seed),
            **kw)
        torch.cuda.synchronize()
        token_ms = [a.elapsed_time(e) for a, e in zip([start] + marks, marks)]
        got = {k: v for counts in launch_counts() for k, v in counts.items()
               if v}
        return grid, {"first_token_ms": token_ms[0],
                      "ms_per_token": statistics.mean(token_ms[1:]),
                      "tokens_per_s": grid.numel() / sum(token_ms) * 1e3,
                      "launches": got}

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
    want = {"ffn_int8": cfg.n_layer * seq}
    if (out["exact_graph"]["launches"] != {}
            or out["ffn_int8_graph"]["launches"] != want
            or not (out["same_seed_same_tokens"]
                    and out["other_seed_other_tokens"]
                    and out["tokens_in_range"])):
        raise AssertionError(f"serve through the token-step graph: {out}, "
                             f"expected launches {want}")
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
            kw = dict(top_k=500, top_p=0.95, cond_scale=3.0, dtype=dtype,
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

    # phase 2: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    import triton
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s; "
        f"triton {triton.__version__}")
    for stem in libs:
        log(_build.build_log(stem).strip())
    log("launch_floor_ms", json.dumps(launch_floor_ms()))

    # phase 3: kernels at the shapes expe5 gives them
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

    # phase 4: the recon slice through its entry point
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

    # phase 5: the train slice through its entry point
    train = train_slice(step_launches, gn_calls)
    torch.cuda.empty_cache()

    # phase 6: cross-checks against the CPU in f32 through the plain versions
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

    # phase 7: the serve slice through its entry point, and its cross-check
    _, serve_launches = serve_slice()
    torch.cuda.empty_cache()
    serve_graph_routes()
    serve_cross_check()

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
        train["launches"], recon_launches)
        + int8_kernel_rows(int8_checks, serve_launches),
        "group_norm_act_per_batch": gn_total,
        "group_norm_act_backward_per_train_step": bwd_total}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
