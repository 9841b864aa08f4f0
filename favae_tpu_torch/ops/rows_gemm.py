"""A few rows times a bf16 weight, one launch (kernel: `csrc/rows_gemm.cu`).

`rows_linear(x, w)` is `F.linear(x, w)` for decode-shaped inputs: x
(..., K) bf16 with at most `MAX_ROWS` rows once flattened, w (N, K) bf16 in
`nn.Linear`'s layout (`Dense.cast`), y (..., N) bf16; f32 sums and one
rounding of y, as cuBLAS computes it. It replaces no TPU kernel: the JAX
package leaves the token step's projections to XLA. At 16 rows a product
does 16 operations a weight byte against the card's ~295, so it is bound
by its weight's bytes; the kernel cuts the weight's rows into tiles of 64
and K across a thread-block cluster, so that every SM streams (`plan`), and
adds the cluster's partials in a fixed order: one launch, no workspace, the
same bits in every replay. It is launched as a programmatic dependent of
the kernel before it, so its weights stream before that kernel has
finished (the token step's Triton kernels, `ops/ln_fused.py` and
`ops/mqa_decode.py`, let it start at their own start).

`Dense.forward` (`models/gpt.py`) takes it where `engages` holds: a CUDA
input with the sampler's cast weight (`Dense.cast`, set only with
gradients off) in bf16, at most `MAX_ROWS` rows and K a multiple of 8 (the
tensor map's row stride is a multiple of 16 bytes). Every other call keeps
`F.linear`.

CUDA tensors take the kernel; CPU tensors take the plain version,
`rows_linear_plain`, the same arithmetic in PyTorch, which is the kernel's
oracle on the card. The wrapper raises on what the kernel does not take: it
never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from favae_tpu_torch import _build
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, MAX_CLUSTER,
                                             SMEM_MAX, check_cuda, launch_on,
                                             sm_count)

# kernel launches since the last reset (graphs.launch_counts); the bytes
# they had to move, the weight, x and y of each (graphs.work_counts)
LAUNCHES = {"rows_gemm": 0}
WORK = {"bytes": 0.0}

# two groups of the tensor core's n = 8 side. Beyond, the kernel lost to
# cuBLAS in gpt2_medium's token step on an H100 80GB HBM3 at 700 W (median
# ms a token with the kernel's 4 and 8 groups, against cuBLAS: 1.995 and
# 1.936 at 32 rows, 3.050 and 1.971 at 64); it won at 16 rows (1.662
# against 1.905) and at 4 and 8.
MAX_ROWS = 16
TN = 64         # weight rows of a block's tile
SK = 64         # depths of a stage of the ring (128 bytes of a weight row)
# the ring's stages, at most, and the blocks an SM the cluster along K grows
# to: of caps 3, 4, 6 and 12 and of 2, 4 and 8 blocks an SM, 6 and 4 gave
# gpt2_medium's token step its least median ms a token on an H100 80GB HBM3
# at 700 W (1.504-1.511, against 1.573-1.585 at 6 and 2, and 1.874 through
# cuBLAS); a guess, not measured: a deeper ring, filled while the kernel
# before still runs, takes bandwidth from it
MAX_DEPTH = 6
BLOCKS_PER_SM = 4
STATIC_SMEM = 1024   # a block's static shared memory, rounded up (mbarriers)
SMEM_SM = 233472     # shared memory of an SM, for the blocks resident on it
SMEM_RESERVED = 1024  # what CUDA keeps of it for each block


def engages(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether `Dense.forward` with the cast weight `w` takes the kernel: a
    CUDA x, w in bf16, at most MAX_ROWS rows, K a multiple of 8."""
    k = x.shape[-1]
    return (x.is_cuda and w.dtype == torch.bfloat16 and k % 8 == 0
            and 0 < x.numel() <= MAX_ROWS * k)


class Plan(NamedTuple):
    """How the kernel cuts (rows, K) x (N, K)^T: `nb` groups of 8 rows,
    a cluster of `ranks` blocks along K, rank r taking depths
    [r kc, (r + 1) kc) through a ring of `depth` stages."""
    nb: int
    ranks: int
    kc: int
    depth: int

    def smem(self) -> int:
        """Dynamic shared memory of a block, as csrc/rows_gemm.cu lays it
        out (its `favae_rows_gemm_smem`, which the card test holds equal to
        this): 1 KB to align the ring, the ring's stages of TN x SK bf16,
        the peers' f32 partials of the block's slice, the activations of
        the chunk at a row stride of 8 mod 64 bf16."""
        kc_pad = -(-self.kc // SK) * SK
        ldx = kc_pad + ((8 - kc_pad % 64) + 64) % 64
        return (1024 + self.depth * TN * SK * 2 + 8 * self.nb * TN * 4
                + 8 * self.nb * ldx * 2)

    def resident(self, sms: int) -> int:
        """Blocks of this plan the card holds at once."""
        return sms * (SMEM_SM // (self.smem() + STATIC_SMEM + SMEM_RESERVED))


@functools.lru_cache(maxsize=None)
def plan(rows: int, k: int, n: int, sms: int = DEFAULT_SMS) -> Plan:
    """The cluster along K doubles (up to 8, and while each rank keeps a
    stage) until the blocks number four an SM; the ring is the deepest (up
    to a rank's stages and MAX_DEPTH) that keeps every block resident at
    once, so that a block launched early (the kernel is a programmatic
    dependent) has its ring in flight before the kernel before ends."""
    if not 0 < rows <= MAX_ROWS:
        raise ValueError(f"rows_linear: {rows} rows, at most {MAX_ROWS}")
    nb = 1 if rows <= 8 else 2
    tiles = -(-n // TN)
    ranks = 1
    while (ranks < MAX_CLUSTER and tiles * ranks < BLOCKS_PER_SM * sms
           and k >= SK * 2 * ranks):
        ranks *= 2
    kc = -(-(-(-k // ranks)) // SK) * SK
    stages = kc // SK
    p = next((Plan(nb, ranks, kc, d)
              for d in range(min(stages, MAX_DEPTH), 0, -1)
              if Plan(nb, ranks, kc, d).resident(sms) >= tiles * ranks),
             Plan(nb, ranks, kc, min(stages, MAX_DEPTH)))
    if p.smem() > SMEM_MAX - STATIC_SMEM:
        raise ValueError(f"rows_linear: K = {k} at {rows} rows needs "
                         f"{p.smem()} bytes of shared memory a block")
    return p


def launch_bytes(rows: int, k: int, n: int) -> int:
    """What a launch must move: the weight and x read once, y written
    once, bf16."""
    return 2 * (n * k + rows * k + rows * n)


def rows_linear_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: bf16 x and w, their products
    summed in f32, one rounding to bf16."""
    return (x.bfloat16().float() @ w.bfloat16().float().t()).bfloat16()


@functools.lru_cache(maxsize=None)
def _kernel(device: torch.device):
    """The launch function, with the kernels' shared-memory allowance set
    on `device`: once a device, not a call."""
    lib = _build.library("rows_gemm")
    with torch.cuda.device(device):
        err = lib.favae_rows_gemm_init(SMEM_MAX - STATIC_SMEM)
    if err != 0:
        raise RuntimeError(f"rows_linear: cudaFuncSetAttribute failed with "
                           f"CUDA error {err}")
    fn = lib.favae_rows_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """One launch into y (rows, N) from checked, contiguous x (rows, K)
    and w (N, K), as a programmatic dependent of the kernel before it."""
    (rows, k), n = x.shape, w.shape[0]
    p = plan(rows, k, n, sm_count(x.device))
    err = launch_on(x.device, _kernel(x.device), x.data_ptr(), w.data_ptr(),
                    y.data_ptr(), rows, k, n, *p,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rows_linear: CUDA launch failed with error {err}")
    LAUNCHES["rows_gemm"] += 1
    WORK["bytes"] += launch_bytes(rows, k, n)


def rows_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T -> (..., N), bf16: one launch for CUDA
    tensors (at most MAX_ROWS rows, K a multiple of 8, w 16-byte
    aligned), the plain version for CPU tensors."""
    if w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"rows_linear: shapes {tuple(x.shape)} and "
                         f"{tuple(w.shape)} are not (..., K) and (N, K)")
    k, n = w.shape[1], w.shape[0]
    if x.device.type == "cpu":
        return rows_linear_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"rows_linear: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError("rows_linear: tensors that record gradients (the "
                         "kernel has no backward)")
    x2 = x.reshape(-1, k).contiguous()
    check_cuda("rows_linear", x.device, [(x2, torch.bfloat16),
                                         (w, torch.bfloat16)])
    if k % 8 or w.data_ptr() % 16 or n == 0:
        raise ValueError(f"rows_linear: on the card K = {k} must be a "
                         f"multiple of 8, w 16-byte aligned and N = {n} "
                         "non-zero")
    y = torch.empty((x2.shape[0], n), dtype=torch.bfloat16, device=x.device)
    launch(x2, w, y)
    return y.reshape(*x.shape[:-1], n)
