"""Microseconds per phase of the int8 FFN kernel (`csrc/ffn_int8.cu`).

    python -m favae_tpu_torch.cli.profile_ffn [--rows 8] [--k 1280 1536]

Compiles a copy of `csrc/ffn_int8.cu` into `build/` with a time mark
(`%globaltimer`, ns) that each worker's thread 0 writes after each step,
loads it in place of the kernel's library, runs a call cold (after calls on
other copies of the weights, 128 MB in all) and prints, for each mark, how
many workers wrote it and the median and latest microseconds after the first
worker's start. It also times the copy as `chip_smoke.py` does (`device_ms`,
`cold_ms`). The marks:

  0 start (boxes asked for)        6 fc2 products done
  1 fc1 products begin             7 fc2 finish: the tile's chunks all in
  2 fc1 products done              8 fc2 finish done
  3 fc1 finish: the tile's chunks  9 block done
    all in                        10 LN_in's start done (block)
  4 fc1 finish done               11 fc2 finish: its loads added
  5 fc2: its fc1 tiles finished

A mark that a change of the source has moved fails the run: the markers are
anchored on lines of the source.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

MARKS = 12
MAX_WORKERS = 600
# (anchor, mark inserted before it) and (anchor, mark inserted after it)
BEFORE = [
    ("  float2* stats = reinterpret_cast<float2*>(", 0),
    ("    if (rv > 8)\n      pass_products<2>(w, t, slot, ldx, part, rows, r0);",
     1),
    ("  arrive(w, a.counters + cn.cnt1 + t.tile);", 2),
    ("  arrive(w, a.counters + cn.fin1 + t.tile);", 4),
    ("  const int kc_pad = t.stages * SK;", 5),
    ("  arrive(w, a.counters + cn.cnt2 + t.tile);", 6),
    ("    w.sync();  // red is free\n  }\n}\n\n// Every box", 8),
    ("  __syncthreads();\n  if (threadIdx.x == 0)\n    last_block", 9),
]
AFTER = [
    ("  wait_for(w, a.counters + cn.cnt1 + t.tile, nch);\n", 3),
    ("  wait_for(w, a.counters + cn.cnt2 + t.tile, nch);\n", 7),
    ("  __syncthreads();  // the mbarriers are initialised, LN_in's start is "
     "done\n", 10),
    ("    if (w.tid < 2 * tiles1) w.red[w.tid] = hv;  // [sum][tile]\n", 11),
]


def marked_source(src: str) -> str:
    """The kernel's source with the marks and a function that reads them."""
    head = (f"__device__ unsigned long long g_clock[{MAX_WORKERS * MARKS}];\n"
            "#define CLK(m) if (w.tid == 0) { unsigned long long t_; "
            'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
            f"g_clock[(w.half * gridDim.x + blockIdx.x) * {MARKS} + (m)] = "
            "t_; }\n")
    anchor = "namespace {\n\nusing namespace favae;\n"
    for text, where in [(anchor, "after")] + [(a, "before") for a, _ in BEFORE]\
            + [(a, "after") for a, _ in AFTER]:
        if src.count(text) != 1:
            raise RuntimeError(f"profile_ffn: anchor not found once: {text!r}")
    src = src.replace(anchor, anchor + head)
    for text, m in BEFORE:
        src = src.replace(text, f"  CLK({m})\n" + text)
    for text, m in AFTER:
        src = src.replace(text, text + f"  CLK({m})\n")
    src = src.replace("  CLK(1)\n    if (rv > 8)", "    if (r0 == 0) CLK(1)\n"
                      "    if (rv > 8)")
    return src + (
        '\nextern "C" int favae_ffn_clock(void* host, int zero) {\n'
        "  static unsigned long long z[sizeof(g_clock) / 8];\n"
        "  return (int)(zero ? cudaMemcpyToSymbol(g_clock, z, sizeof(z))\n"
        "                    : cudaMemcpyFromSymbol(host, g_clock, "
        "sizeof(g_clock)));\n}\n")


def build() -> ctypes.CDLL:
    from favae_tpu_torch import _build
    src = _build.BUILD_DIR / "ffn_int8_marked.cu"
    lib = _build.BUILD_DIR / "libffn_int8_marked.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(marked_source((_build.CSRC / "ffn_int8.cu").read_text()))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--k", type=int, nargs="+", default=[1280, 1536])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from favae_tpu_torch.ops import ffn_int8 as fi
    lib = build()
    real = fi._library()
    for name in ("favae_ffn_int8", "favae_ffn_int8_init",
                 "favae_ffn_int8_grid"):
        fn, orig = getattr(lib, name), getattr(real, name)
        fn.argtypes, fn.restype = orig.argtypes, orig.restype
    lib.favae_ffn_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fi._library = functools.lru_cache(maxsize=None)(lambda: lib)
    fi._grid.cache_clear()
    print(cs.nvidia_smi())
    for k in args.k:
        x, g, prep = cs.ffn_case(args.rows, k, 1)
        copies = cs.cold_copies(cs.nbytes(*prep.values()))
        preps = [{n: v.clone() for n, v in prep.items()}
                 for _ in range(copies)]
        row = {"shape": f"rows={args.rows} K={k} F={4 * k}",
               "device_ms": cs.device_ms(lambda: fi.ffn_block_int8(x, g,
                                                                   prep)),
               "cold_ms": cs.cold_ms(
                   lambda i: lambda: fi.ffn_block_int8(x, g, preps[i]),
                   copies)}
        buf = (ctypes.c_ulonglong * (MAX_WORKERS * MARKS))()
        for _ in range(args.repeats):
            for i in range(copies - 1):
                fi.ffn_block_int8(x, g, preps[i])
            torch.cuda.synchronize()
            lib.favae_ffn_clock(None, 1)
            fi.ffn_block_int8(x, g, preps[-1])
            torch.cuda.synchronize()
            lib.favae_ffn_clock(buf, 0)
            t = np.array(buf, dtype=np.float64).reshape(MAX_WORKERS, MARKS)
            t0 = t[:, 0][t[:, 0] > 0].min()
            row.setdefault("marks", []).append({
                m: [int((t[:, m] > 0).sum()),
                    round(float(np.median(t[:, m][t[:, m] > 0] - t0)) / 1e3, 2),
                    round(float((t[:, m][t[:, m] > 0] - t0).max()) / 1e3, 2)]
                for m in range(MARKS) if (t[:, m] > 0).any()})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    main()
