"""Weight-only int8 matmul (kernel: `csrc/int8_matmul.cu`).

Port of `favae_tpu/ops/int8_matmul.py`: `quantize_weight` gives a (K, N)
matrix per-output-column symmetric int8 weights and f32 scales;
`matmul_int8` computes `(x @ dequant(wq)) * scale` with the weights
dequantised on the fly, so their bf16 copy never exists in device memory.
With M <= 16 rows the product is bound by the K * N bytes of int8 weights;
the kernel splits K as well as N over the blocks so that the card's SMs all
stream (a ring of TMA requests a block, `mma.sync` products), and the blocks of a
column tile, one thread-block cluster along K, add their partial products
through distributed shared memory in a fixed order (one launch, no float
atomics). `matmul_plan` cuts a shape into row groups, cluster and chunk of K.

As in the JAX package, no sampler calls `matmul_int8`: the serving engines
use the fused FFN block (`ops/ffn_int8.py`) or the whole-step kernel
(`ops/decode_step_kernel.py`), both of which share this kernel's tensor-core
stage (`csrc/int8_mma.cuh`). It is kept as an op with its kernel.

`matmul_int8` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version, `matmul_int8_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from favae_tpu_torch import _build

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"matmul_int8": 0}

DEFAULT_SMS = 132   # H100 SXM

# csrc/int8_matmul.cu over csrc/int8_mma.cuh
MMA_TN = 128          # columns of a block's tile
MMA_K = 16            # depth of one mma.sync: chunks of K are multiples of it
MMA_KC_MAX = 4096     # 16 rows x this many bf16 activations beside the ring
MAX_CLUSTER = 8       # the portable thread-block cluster size
SMEM_MAX = 232448     # bytes of shared memory a block can use (227 KB)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 quantisation of a (K, N) matrix:
    scale = amax / 127 (1 where the column is zero), round half to even,
    clip to +-127. Returns (wq int8 (K, N), scale f32 (1, N))."""
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq.contiguous(), scale.contiguous()


class MatmulPlan(NamedTuple):
    """How `matmul_int8` cuts (M, K) x (K, N): column tiles of `MMA_TN`, row
    groups of 8 * `nb`, and a cluster of `ranks` blocks along K, rank r
    taking rows [r * kc, (r + 1) * kc) of the weights."""
    nb: int
    ranks: int
    kc: int

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        return self.ranks, -(-n // MMA_TN), -(-m // (8 * self.nb))

    def smem(self) -> int:
        """Dynamic shared memory of a block, as csrc/int8_matmul.cu lays it
        out: 1 KB to align the ring, 5 stages of 64 rows x 128 bytes, the
        f32 partial, bf16 activations (the chunk rounded up to a stage of 64
        rows) at a row stride of 8 mod 64."""
        ldx = -(-self.kc // 64) * 64 + 8
        return (1024 + 5 * 64 * MMA_TN + 8 * self.nb * MMA_TN * 4
                + 8 * self.nb * ldx * 2)


@functools.lru_cache(maxsize=None)
def matmul_plan(m: int, k: int, n: int, sms: int = DEFAULT_SMS) -> MatmulPlan:
    """The cluster along K doubles (up to 8, and while a rank keeps 64 rows)
    until the blocks number two an SM."""
    nb = 2 if m > 8 else 1
    tiles = -(-n // MMA_TN) * -(-m // (8 * nb))
    ranks = 1
    while (ranks < MAX_CLUSTER and tiles * ranks < 2 * sms
           and k >= 64 * 2 * ranks):
        ranks *= 2
    kc = -(-(-(-k // ranks)) // MMA_K) * MMA_K
    if kc > MMA_KC_MAX:
        raise ValueError(f"matmul_int8: K = {k} needs chunks of {kc} rows, "
                         f"more than {MMA_KC_MAX}")
    return MatmulPlan(nb, ranks, kc)


def matmul_int8_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x rounded to bf16, exact
    bf16 x int8 products summed in f32, the scale applied after the sum, one
    rounding to out_dtype."""
    acc = x.bfloat16().float() @ wq.float()
    return (acc * scale.float().reshape(1, -1)).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel(device: torch.device):
    """The launch function, with the kernels' shared-memory allowance set
    on `device`: once a device, not a call."""
    lib = _build.library("int8_matmul")
    with torch.cuda.device(device):
        err = lib.favae_matmul_int8_init(MMA_KC_MAX)
    if err != 0:
        raise RuntimeError(f"matmul_int8: cudaFuncSetAttribute failed with "
                           f"CUDA error {err}")
    fn = lib.favae_matmul_int8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_on(device: torch.device, fn, *args) -> int:
    """Call the launch function `fn` with `device` current (a kernel
    launches on the current device); returns its CUDA error."""
    if torch.cuda.current_device() == device.index:
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def stream_counters(table: dict, name: str, device: torch.device,
                    stream: int, capturing: bool, size: int) -> torch.Tensor:
    """The integer arrival counters of kernel `name`'s launches on one
    stream (`stream`, the CUDA stream's handle) of `device`, `size` of them,
    kept in `table`: zero between launches (the kernel sets them back), and
    never shared by launches in flight on two streams at once. Made at the
    first launch on the stream, which must not be one that a CUDA graph
    captures (`capturing`): the counters would then live in the graph's
    memory pool, so that call raises."""
    key = (device, stream)
    counters = table.get(key)
    if counters is None:
        if capturing:
            raise RuntimeError(
                f"{name}: the first launch on a stream is being captured by a "
                "CUDA graph; call it once on that stream before the capture, "
                "so that its arrival counters exist")
        counters = torch.zeros(size, dtype=torch.int32, device=device)
        table[key] = counters
    return counters


def check_cuda(name: str, device: torch.device, tensors) -> None:
    """Raise unless every (tensor, dtype) pair lies on `device`, has that
    dtype and is contiguous."""
    for t, dtype in tensors:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dtype} tensor on {device}, "
                f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")


def matmul_int8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) bf16/f32 @ dequant(wq (K, N) int8, scale (1, N) f32) ->
    (M, N) in out_dtype (bf16 or f32). On the card N must be a multiple of
    16 and wq 16-byte aligned (what a tensor map of the weights asks)."""
    if x.device.type == "cpu":
        return matmul_int8_plain(x, wq, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8: unsupported device {x.device}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"matmul_int8: shapes {tuple(x.shape)} and "
                         f"{tuple(wq.shape)} are not (M, K) and (K, N)")
    m, k = x.shape
    n = wq.shape[1]
    if scale.shape != (1, n) or n % 4 or m == 0 or k == 0:
        raise ValueError(f"matmul_int8: scale {tuple(scale.shape)} must be "
                         f"(1, {n}), N a multiple of 4, M and K non-zero")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_int8: out_dtype {out_dtype} not supported")
    x = x.bfloat16()
    check_cuda("matmul_int8", x.device, [(x, torch.bfloat16), (wq, torch.int8),
                                         (scale, torch.float32)])
    if n % 16 or wq.data_ptr() % 16:
        raise ValueError(f"matmul_int8: on the card N = {n} must be a "
                         "multiple of 16 and wq 16-byte aligned")
    plan = matmul_plan(m, k, n, sm_count(x.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = launch_on(
        x.device, _kernel(x.device), x.data_ptr(), wq.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, k, n, *plan,
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_int8: CUDA launch failed with error {err}")
    LAUNCHES["matmul_int8"] += 1
    return out
