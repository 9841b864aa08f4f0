"""Microseconds per step of the GroupNorm backward sums kernel
(`csrc/gn_bwd_sums.cu`).

    python -m favae_tpu_torch.cli.profile_gn_bwd [--shape 16 512 16 16 silu]

Compiles a copy of the kernel with `-DGN_BWD_MARKS` into `build/` (thread 0
of each block writes `%globaltimer`, ns, at each step), runs one call of
`ops.gn.gn_bwd_sums` through it at each shape (bf16 x and dy, 32 groups; by
default every shape of a celebahq_expe5 train step's backward) and prints,
for each mark, how many blocks wrote it and the median and latest
microseconds after the first block's start. It also times the kernel's own
build and the marked copy as `chip_smoke.py` does (`device_ms`, the call
replayed in a CUDA graph, the sum over images included). The marks:

  7 block start                  3 its partial written
  0 constants read (consumers)   4 arrived on the image's counter
  1 first stage landed           5 last block: the image's sums added
  2 stream done                  6 last block: fold written
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

import numpy as np

MARKS = 8
MARK_BLOCKS = 1 << 14
NAMES = {7: "block start", 0: "constants read", 1: "first stage landed",
         2: "stream done", 3: "partial written", 4: "arrived",
         5: "last block: sums added", 6: "last block: fold written"}
CENSUS = [(16, 128, 256, 256, "silu"), (16, 128, 128, 128, "silu"),
          (16, 256, 128, 128, "silu"), (16, 256, 64, 64, "silu"),
          (16, 256, 32, 32, "silu"), (16, 512, 32, 32, "silu"),
          (16, 512, 16, 16, None), (16, 512, 16, 16, "silu"),
          (16, 256, 16, 16, "silu"), (16, 128, 64, 64, "silu")]


def build() -> ctypes.CDLL:
    from favae_tpu_torch import _build
    lib = _build.BUILD_DIR / "libgn_bwd_sums_marked.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DGN_BWD_MARKS", "-o", str(lib),
         str(_build.CSRC / "gn_bwd_sums.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("profile_gn_bwd: nvcc failed:\n" + proc.stdout
                           + proc.stderr)
    return ctypes.CDLL(str(lib))


def marked_kernel(lib: ctypes.CDLL):
    if lib.favae_gn_bwd_sums_init() != 0:
        raise RuntimeError("profile_gn_bwd: cudaFuncSetAttribute failed")
    fn = lib.favae_gn_bwd_sums
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def read_marks(lib: ctypes.CDLL, blocks: int) -> np.ndarray:
    host = np.zeros(MARK_BLOCKS * MARKS, dtype=np.uint64)
    if lib.favae_gn_bwd_clock(ctypes.c_void_p(host.ctypes.data), 0) != 0:
        raise RuntimeError("profile_gn_bwd: reading the marks failed")
    return host.reshape(MARK_BLOCKS, MARKS)[:blocks]


def profile(shape, lib, fn, seed=0) -> dict:
    import torch

    import chip_smoke as cs
    from favae_tpu_torch.ops import gn
    n, c, h, w, act = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    x = (torch.randn(n, c, h, w, device="cuda", generator=g) * 2 + 0.5
         ).bfloat16().contiguous(memory_format=cl)
    dy = torch.randn(n, c, h, w, device="cuda", generator=g).bfloat16(
        ).contiguous(memory_format=cl)
    scale = torch.randn(c, device="cuda", generator=g)
    bias = torch.randn(c, device="cuda", generator=g)
    a, b, mean, inv = gn.gn_affine(gn.gn_stats_plain(x), scale, bias, 32,
                                   h * w, 1e-5)

    def call():
        return gn.gn_bwd_sums(x, dy, a, b, scale, mean, inv, act)

    own = gn._bwd_kernel
    row = {"shape": list(shape),
           "plan": list(gn.bwd_sums_plan(n, h * w, c, 2, 2,
                                         gn.sm_count(x.device))),
           "device_ms": cs.device_ms(call)}
    gn._bwd_kernel = functools.lru_cache(maxsize=None)(lambda device: fn)
    try:
        row["marked_device_ms"] = cs.device_ms(call)
        call()
        torch.cuda.synchronize()
        if lib.favae_gn_bwd_clock(None, 1) != 0:
            raise RuntimeError("profile_gn_bwd: zeroing the marks failed")
        call()
        torch.cuda.synchronize()
    finally:
        gn._bwd_kernel = own
    t = read_marks(lib, n * row["plan"][0]).astype(np.int64)
    t0 = t[:, 7][t[:, 7] > 0].min()
    for m in (7, 0, 1, 2, 3, 4, 5, 6):
        us = (t[:, m][t[:, m] > 0] - t0) / 1e3
        row[NAMES[m]] = ({"blocks": int(us.size),
                          "median_us": float(np.median(us)),
                          "last_us": float(us.max())} if us.size else None)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs=5, action="append", metavar=(
        "N", "C", "H", "W", "ACT"), help="ACT is silu or none")
    args = ap.parse_args(argv)
    shapes = [(*map(int, s[:4]), None if s[4] == "none" else s[4])
              for s in args.shape] if args.shape else CENSUS
    lib = build()
    fn = marked_kernel(lib)
    import chip_smoke as cs
    print(cs.nvidia_smi(), flush=True)
    rows = [profile(s, lib, fn) for s in shapes]
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
