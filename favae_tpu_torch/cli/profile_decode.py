"""Where a token's time goes inside the whole-decode-step kernel.

Runs `decode_step_fused` on the card at a GPT preset's full width and depth
with seeded random weights and prints one JSON line: the kernel's time at a
few positions (CUDA events) and, from the timestamps block 0 writes after
each grid barrier, the mean time of each of a layer's phases
(`ops.decode_step_kernel.PHASES`, one grid barrier after each), split into
the work (until the last block reached the barrier) and the barrier.

    python -m favae_tpu_torch.cli.profile_decode [--gpt_name gpt2_medium]
    python -m favae_tpu_torch.cli.profile_decode --pos_reads [--repeats 3]

`--pos_reads` instead compares where the self-attention items take the
position from: the kernel as built reads it once at entry and passes it to
them as an argument (`kept`); copies of its source built beside it read it
again from device memory in each item (`item`) or keep what each block read
at entry in a shared word (`shared`). All take the same device position and
must give the same bits. They are timed in turns in one process (kept,
item, shared, then backwards), `ms` and `device_ms` as `chip_smoke.py`
times row 6, on `chip_smoke.check_decode_step`'s cross bias and on one
without the short prompt's row, at the last position.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

import numpy as np
import torch

_SIGNATURE = ("int row, int head, float* sm, const int pos) {\n",
              "int row, int head, float* sm) {\n")
_ATTEND = "template <bool SELF>\n__device__ void attend_item("
_ENTRY = "  cg::grid_group grid = cg::this_grid();\n"
_CALLS = [("it % p.heads, xs, pos);\n        else",
           "it % p.heads, xs);\n        else"),
          ("it % p.heads, xs, pos);\n      }", "it % p.heads, xs);\n      }")]
# (text, replacement) pairs that turn csrc/decode_step.cu into each variant
POS_VARIANTS = {
    "item": [(_SIGNATURE[0], _SIGNATURE[1] + "  const int pos = "
                             "static_cast<int>(__ldg(p.pos));\n"), *_CALLS],
    "shared": [
        (_SIGNATURE[0], _SIGNATURE[1] + "  const int pos = g_pos_at_entry;\n"),
        (_ATTEND, "__shared__ int g_pos_at_entry;\n\n" + _ATTEND),
        (_ENTRY, _ENTRY + "  if (threadIdx.x == 0) "
                          "g_pos_at_entry = static_cast<int>(pos);\n"),
        *_CALLS],
}


def build_variants() -> dict:
    """The kernel's library and one built copy a variant, {name: CDLL},
    each with the argument types of `decode_step_kernel._library`, and
    {name: ptxas spill lines}."""
    from favae_tpu_torch import _build
    from favae_tpu_torch.ops import decode_step_kernel as dk
    kept = dk._library()
    src = (_build.CSRC / "decode_step.cu").read_text()
    jobs = {}
    for name, edits in POS_VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"profile_decode: {name}: anchor not "
                                   f"found once: {old!r}")
            text = text.replace(old, new)
        path = _build.BUILD_DIR / f"decode_step_{name}.cu"
        path.write_text(text)
        lib = path.with_name(f"libdecode_step_{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {"kept": kept}
    spills = {"kept": [ln for ln in _build.build_log("decode_step")
                       .splitlines() if "spill" in ln]}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn in ("favae_decode_step", "favae_decode_step_grid",
                   "favae_decode_step_scratch", "favae_decode_step_smem"):
            ours, theirs = getattr(lib, fn), getattr(kept, fn)
            ours.argtypes, ours.restype = theirs.argtypes, theirs.restype
        libs[name] = lib
        spills[name] = [ln for ln in log.splitlines() if "spill" in ln]
    return libs, spills


def pos_reads(gpt_name: str, rows: int, m_cross: int, repeats: int) -> dict:
    import chip_smoke as cs
    from favae_tpu_torch import config as C
    from favae_tpu_torch.models.gpt import GPT
    from favae_tpu_torch.ops import decode_step_kernel as dk
    libs, spills = build_variants()
    cfg = getattr(C, gpt_name)(vocab_size=1024, n_cond_embed=768)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        gpt = GPT(cfg).cuda().eval()
    n_layer, heads, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    seq = cfg.image_encoded_dim ** 2
    rng = np.random.RandomState(11)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    with torch.inference_mode():
        fused = dk.prepare_fused_decode(gpt, cfg)
        x = t(rows, d).bfloat16()
        caches = t(n_layer, rows, seq, dh).bfloat16()
        cross_kv = t(n_layer, rows, m_cross, dh).bfloat16()
        rel = t(n_layer, heads, seq + 1)
        rel[..., 0] = 0.0
        cfg_half = torch.zeros(rows, m_cross, device="cuda")
        cfg_half[rows // 2:, 1:] = -1e9   # the null-text half of a CFG batch
        short = cfg_half.clone()
        short[0, 20:] = -1e9              # and a short prompt (chip_smoke's)
        pos = torch.full((), seq - 1, dtype=torch.long, device="cuda")
        names = list(libs)
        out = {"card": cs.nvidia_smi(), "gpt_name": gpt_name, "rows": rows,
               "pos": seq - 1, "spills": spills, "same_bits_as_kept": {},
               "turns": []}
        kept_bits = {}
        for r in range(repeats):
            for name in names if r % 2 == 0 else names[::-1]:
                dk._library = functools.lru_cache(maxsize=None)(
                    lambda lib=libs[name]: lib)
                dk._GRIDS.clear()
                turn = {"variant": name}
                for data, bias in (("cross_bias", short),
                                   ("cfg_half_only", cfg_half)):
                    c = caches.clone()
                    step = functools.partial(
                        dk.decode_step_fused, x, pos, c, cross_kv, bias, rel,
                        fused, cfg)
                    x_new, _ = step()
                    bits = (x_new.clone(), c[:, :, seq - 1].clone())
                    if name == "kept":
                        kept_bits[data] = bits
                    elif data in kept_bits:
                        out["same_bits_as_kept"][f"{name}/{data}"] = all(
                            torch.equal(a, b)
                            for a, b in zip(bits, kept_bits[data]))
                    turn[data] = {"ms": cs.time_ms(step, iters=50),
                                  "device_ms": cs.device_ms(step, calls=20)}
                dk.check_positions(x.device)
                out["turns"].append(turn)
                print(json.dumps(turn), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpt_name", default="gpt2_medium",
                   choices=["gpt2_mini", "gpt2_medium"])
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--m_cross", type=int, default=78)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--pos_reads", action="store_true")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    if args.pos_reads:
        out = pos_reads(args.gpt_name, args.rows, args.m_cross, args.repeats)
        print(json.dumps(out))
        return out
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
