"""Build and load the hand-written CUDA kernels at first use.

Each `csrc/*.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers, so
a build takes seconds). Libraries land in `build/favae_tpu_torch/` at the
root of the checkout, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. All sources compile in
parallel, one `nvcc` each. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "favae_tpu_torch"
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of favae_tpu_torch are built at first use")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns {stem: path}."""
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=f, stderr=subprocess.STDOUT)
        jobs.append((src, out, tmp, log, proc))
    failed = []
    for src, out, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n{log.read_text()}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {src.stem: _lib_path(src) for src in srcs}


def build_log(stem: str) -> str:
    """The compiler's output (ptxas resource usage) for one source."""
    log = _lib_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, building it first if needed."""
    if stem not in _LIBS:
        _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
    return _LIBS[stem]
