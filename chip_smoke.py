"""Drive favae_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. device: print `nvidia-smi` name and power limit; fail without CUDA;
2. build: compile the CUDA kernels from this checkout's `csrc/` (timed);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the shapes celebahq_expe5 reconstruction gives it, timed beside
   its bound and a one-call PyTorch yardstick;
4. slice: `favae_tpu_torch.cli.eval_favae` at celebahq_expe5, batch 16,
   256 px, bf16, seeded random weights, with the kernels' launch counts
   zeroed just before and read just after;
5. cross-check: the same weights and 2 images reconstructed on the card
   (bf16, and f32 with TF32 off) and on the CPU in f32 through the plain
   versions.
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
VQ_NEAR_TIE = 1e-5          # a chosen code may trail the best score by this
SLICE_ARGS = ["--preset", "celebahq_expe5", "--synthetic_data",
              "--batch_size", "16", "--max_images", "64"]
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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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
    row = {
        "shape": f"N={n} K={k} D={d} {metric}",
        "max_abs_err": gap, "index_mismatches_vs_plain": mismatch,
        "ms": time_ms(lambda: vq.vq_nearest(x, e, bias)),
        "plain_ms": time_ms(lambda: vq.vq_nearest_plain(x, e, bias)),
        "library_ms": time_ms(
            lambda: torch.argmax(torch.addmm(b, x, e.T), dim=-1)),
    }
    row["bound_ms"], row["bound_by"] = bound(
        4 * (n * d + k * d + (k if bias is not None else 0) + n),
        2 * n * k * d)
    log("vq", json.dumps(row))
    if gap > VQ_NEAR_TIE:
        raise AssertionError(f"vq_nearest {row['shape']}: chosen code trails "
                             f"the best score by {gap} > {VQ_NEAR_TIE}")
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


def check_gn(key, seed):
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

    a, b = gn.gn_affine(p, scale, bias, 32, hw, 1e-5)
    y = gn.gn_apply(x, a, b, act, out_dt).float()
    yp = gn.gn_apply_plain(x, a, b, act, out_dt).float()
    apply_err = (y - yp).abs()
    # one rounding of out_dtype apart at most: 2^-7 relative for bf16
    apply_ok = bool((apply_err <= 1e-5 + 2 ** -7 * yp.abs()).all())

    full = gn.group_norm_act(x, scale, bias, 32, act=act, out_dtype=out_dt)
    full_plain = gn.group_norm_act_plain(x, scale, bias, 32, act=act,
                                         out_dtype=out_dt)
    full_err = (full.float() - full_plain.float()).abs().max().item()
    ws, bs = scale.to(in_dt), bias.to(in_dt)

    def library():
        y = F.group_norm(x, 32, ws, bs, 1e-5)
        return F.silu(y) if act == "silu" else y

    stats_bound = bound(xb + 2 * vec, 3 * elems)[0]
    apply_bound = bound(xb + yb + 2 * vec, 2 * elems)[0]
    row = {
        "shape": f"N={n} C={c} H={h} W={w} act={act} {in_dt}->{out_dt}",
        "stats": {"max_abs_err": stats_abs, "max_rel_err": stats_rel,
                  "ms": time_ms(lambda: gn.gn_stats(x)),
                  "plain_ms": time_ms(lambda: gn.gn_stats_plain(x)),
                  "bound_ms": stats_bound},
        "apply": {"max_abs_err": apply_err.max().item(),
                  "ms": time_ms(lambda: gn.gn_apply(x, a, b, act, out_dt)),
                  "plain_ms": time_ms(
                      lambda: gn.gn_apply_plain(x, a, b, act, out_dt)),
                  "bound_ms": apply_bound},
        "group_norm_act": {
            "max_abs_err": full_err,
            "ms": time_ms(lambda: gn.group_norm_act(
                x, scale, bias, 32, act=act, out_dtype=out_dt)),
            "plain_ms": time_ms(lambda: gn.group_norm_act_plain(
                x, scale, bias, 32, act=act, out_dtype=out_dt)),
            "library_ms": time_ms(library),
            "bound_ms": bound(2 * xb + yb, 5 * elems)[0]},
    }
    log("gn", json.dumps(row))
    if stats_rel > 1e-5 or not apply_ok:
        raise AssertionError(f"group norm kernels disagree at {row['shape']}:"
                             f" stats rel err {stats_rel}, apply ok {apply_ok}")
    return row


def per_batch(gn_rows, census, part, field):
    """A GroupNorm number summed over the distinct shapes, each weighted by
    its calls in one reconstruction batch (rows are in census order)."""
    return sum(r[part][field] * n for r, n in zip(gn_rows, census.values()))


def kernel_rows(vq_main, gn_rows, census, launches):
    """The `kernels` line: one entry per kernel; the GroupNorm entries are
    per recon batch (`per_batch`)."""
    rows = [{
        "name": "vq_nearest", "route": "cuda",
        "source": "favae_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "favae_tpu/ops/vq_pallas.py:65",
        "launches": launches["vq_nearest"], "shape": vq_main["shape"],
        **{f: vq_main[f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}]
    for name, part, replaces in (
            ("gn_stats", "stats", "favae_tpu/ops/gn_pallas.py:137"),
            ("gn_apply", "apply", "favae_tpu/ops/gn_pallas.py:178")):
        rows.append({
            "name": name, "route": "triton",
            "source": "favae_tpu_torch/ops/gn.py",
            "replaces": replaces, "launches": launches[name],
            "shape": f"{sum(census.values())} calls over {len(census)} "
                     "shapes, per recon batch",
            "max_abs_err": max(r[part]["max_abs_err"] for r in gn_rows),
            **{f: per_batch(gn_rows, census, part, f)
               for f in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": None})
    return rows


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
    from favae_tpu_torch.config import celebahq_expe5
    from favae_tpu_torch.data.pipeline import SyntheticDataset
    from favae_tpu_torch.models.vqgan import build_model
    from favae_tpu_torch.ops import gn, vq

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

    # phase 3: kernels at the shapes expe5 reconstruction gives them
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
    gn_rows = [check_gn(key, i) for i, key in enumerate(census)]

    # phase 4: the slice through its entry point
    for counts in (vq.LAUNCHES, gn.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = eval_favae.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**vq.LAUNCHES, **gn.LAUNCHES}
    batches = len(metrics["batch_ms"])
    gn_calls = sum(census.values())
    steady = statistics.median(metrics["batch_ms"][1:])
    slice_out = {
        "metrics": {k: metrics[k] for k in ("psnr", "l1", "codebook_usage",
                                            "images")},
        "launches": launches, "batches": batches,
        "gn_calls_per_batch": gn_calls, "batch_ms": metrics["batch_ms"],
        "steady_ms_per_batch": steady, "imgs_per_s": 16e3 / steady,
        "wall_s_incl_model_build": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("slice", json.dumps(slice_out))
    if not all(math.isfinite(metrics[k]) for k in ("psnr", "l1")):
        raise AssertionError("non-finite reconstruction metrics")
    if metrics["images"] != 64 or launches["vq_nearest"] != batches:
        raise AssertionError(f"vq_nearest launched {launches['vq_nearest']} "
                             f"times over {batches} batches")
    if not launches["gn_stats"] == launches["gn_apply"] == batches * gn_calls:
        raise AssertionError(f"GroupNorm kernels launched {launches} times, "
                             f"expected {batches * gn_calls} each")

    with torch.inference_mode():
        recon_ms = time_ms(lambda: model.reconstruct(x16), iters=10)
    log("recon", json.dumps({"device_ms_per_batch": recon_ms,
                             "imgs_per_s": 16e3 / recon_ms}))

    # phase 5: cross-check against the CPU in f32 through the plain versions
    x2 = x16[:2].cpu()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    state = model.state_dict()
    cpu_model = build_model(cfg32, "cpu")
    cpu_model.load_state_dict(state)
    t0 = time.perf_counter()
    ref = cpu_reference(cpu_model, x2)
    log(f"cpu f32 reconstruction of 2 images: {time.perf_counter() - t0:.1f} s")
    gpu32 = build_model(cfg32, "cuda")
    gpu32.load_state_dict(state)
    cross_check("bf16", model, x2, ref)
    cross_check("f32", gpu32, x2, ref)

    # the whole GroupNorm (stats + fold + apply) beside one-call PyTorch
    gn_total = {f: per_batch(gn_rows, census, "group_norm_act", f)
                for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(json.dumps({"kernels": kernel_rows(vq_rows[0], gn_rows, census,
                                           launches),
                    "group_norm_act_per_batch": gn_total}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
