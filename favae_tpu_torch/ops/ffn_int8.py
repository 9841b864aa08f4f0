"""Fused int8 feed-forward block of CAT decode (kernel: `csrc/ffn_int8.cu`).

Port of `favae_tpu/ops/ffn_int8.py`: the whole FeedForward block
(LN -> fc1 -> GELU -> LN -> fc2 -> residual) with both projection matrices
streamed as int8. The mid LayerNorm folds away: with
W2' = gamma_mid[:, None] * W2 and c = colsum(dequantised int8 W2'),

    fc2(LN(h)) = inv * (h @ W2' - mu * c)

where (mu, inv) are h's row statistics, so the product and the sums of h and
h^2 are gathered in one pass over F and the correction is applied once at
the end. GELU is the tanh form here (the exact bf16 engine's is erf).
Bound: the 2 * K * 4K bytes of int8 weights. The TPU kernel carries its sums
across a sequential grid; the CUDA kernel is one cooperative launch that
holds the whole layer's weights in the grid's shared memory, brought by TMA,
and cuts both products into items (a 128-column tile and a chunk of K or of
F) whose partials the items of a tile add, a row each, in a fixed order once
the tile is complete (integer counters, no float atomics), see
`csrc/ffn_int8.cu`. `ffn_plan` picks the chunks;
`work_items`, `scratch_layout`, `counter_layout` and `smem_bytes` are copies
of what the kernel derives from it, for the CPU tests; `chip_smoke.py` holds
them against the library's own.

`ffn_block_int8` launches the CUDA kernel for CUDA tensors and takes the
plain PyTorch version, `ffn_block_int8_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from favae_tpu_torch import _build
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, check_cuda,
                                             launch_on, quantize_weight,
                                             sm_count, stream_counters)

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"ffn_int8": 0}

# csrc/ffn_int8.cu
TILE_N = 128         # columns of a work item
BOX_K = 64           # rows of a TMA box
WORKERS = 2          # workers of 128 threads in a block of 256, one an SM
PASS = 16            # rows of a pass over a worker's boxes
MAX_SLOTS = 32       # boxes a worker holds
MAX_K = 1536         # the widest row the kernel's LN_in holds
MAX_KC1 = 512        # the longest chunk of K an fc1 item normalises
MAX_CHUNKS = (8, 32)  # chunks of K (fc1) and of F (fc2) a finish adds
SMEM_ALLOWED = 224 * 1024  # dynamic shared memory of a block
COUNTERS = 1024      # ints of a stream's arrival counters

_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def prepare_ffn_weights(w1: torch.Tensor, gamma_mid: torch.Tensor,
                        w2: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantise W1 and the gamma-folded W2' and compute the colsum
    correction of the dequantised W2', so that the correction matches the
    int8 weights exactly. w1 (K, F), w2 (F, K), gamma_mid (F,)."""
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(gamma_mid.float()[:, None] * w2.float())
    c = w2q.float().sum(dim=0, keepdim=True) * s2
    return dict(w1q=w1q, s1=s1, w2q=w2q, s2=s2, c=c)


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a learned scale and no bias in f32, two-pass variance,
    as the kernels compute it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float()


def folded_ffn_plain(xn: torch.Tensor, w1q, s1, w2q, s2, c,
                     eps: float) -> torch.Tensor:
    """inv * ((h @ W2') * s2 - mu * c) for h = gelu_tanh((xn @ W1) * s1):
    xn and h rounded to bf16 before their products, h's sums taken in f32
    before that rounding."""
    h = (xn.bfloat16().float() @ w1q.float()) * s1.float().reshape(1, -1)
    h = F.gelu(h, approximate="tanh")
    f = h.shape[-1]
    mu = h.sum(dim=-1, keepdim=True) / f
    var = torch.clamp((h * h).sum(dim=-1, keepdim=True) / f - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    acc = h.bfloat16().float() @ w2q.float()
    return inv * (acc * s2.float().reshape(1, -1)
                  - mu * c.float().reshape(1, -1))


def ffn_block_int8_plain(x: torch.Tensor, gamma_in: torch.Tensor,
                         prep: Dict[str, torch.Tensor],
                         eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, rounding where it rounds."""
    out = folded_ffn_plain(layer_norm_rows(x, gamma_in, eps), prep["w1q"],
                           prep["s1"], prep["w2q"], prep["s2"], prep["c"], eps)
    return (x.float() + out).to(x.dtype)


def chunk_of_k(k: int, n: int, workers: int, unit: int) -> int:
    """Rows of K one item of a (K, N) product takes: a multiple of `unit`,
    as few as keep the (column tile x chunk) items within the workers (one
    item a worker where they allow it)."""
    chunks = max(1, workers // -(-n // TILE_N))
    kc = -(-(-(-k // chunks)) // unit) * unit
    return min(kc, -(-k // unit) * unit)


def work_items(p: dict, product: int) -> List[Tuple[int, ...]]:
    """The items of fc1 (`product` 0: (K, F) in chunks of kc1 rows of K) or
    fc2 (1: (F, K) in chunks of kc2 rows of F) in the kernel's order, column
    tile fastest: (tile, chunk, worker, k0, k1). fc1's items go to the
    workers from the first up, fc2's from the last down, each worker taking
    every `workers`-th."""
    k, n, kc = ((p["k"], p["f"], p["kc1"]) if product == 0
                else (p["f"], p["k"], p["kc2"]))
    tiles, w = n // TILE_N, p["workers"]
    out = []
    for it in range(tiles * -(-k // kc)):
        t, c = it % tiles, it // tiles
        out.append((t, c, it % w if product == 0 else w - 1 - it % w,
                    c * kc, min(k, (c + 1) * kc)))
    return out


def boxes_per_worker(p: dict) -> List[int]:
    """The TMA boxes of BOX_K x TILE_N each worker holds: all of its items'."""
    boxes = [0] * p["workers"]
    for product in (0, 1):
        for _, _, w, k0, k1 in work_items(p, product):
            boxes[w] += -(-(k1 - k0) // BOX_K)
    return boxes


def smem_bytes(p: dict, slots: int, rows: int) -> int:
    """Dynamic shared memory of a block, as csrc/ffn_int8.cu lays it out:
    1 KB to align the boxes, `slots` 8 KB boxes for each of the two workers,
    then each worker's own region: the bf16 activations of a pass (16 rows
    of the longest chunk at a row stride of 8 mod 64) and the finishes'
    sums (a row's 2 x 48 fc1 tile sums at most); last the block's LN_in
    statistics, two floats a row."""
    kc = -(-max(p["kc1"], p["kc2"]) // BOX_K) * BOX_K
    xs = PASS * (kc + ((8 - kc % 64) + 64) % 64) * 2
    own = -(-(xs + 2 * (4 * MAX_K // TILE_N) * 4) // 128) * 128
    return (1024 + WORKERS * slots * BOX_K * TILE_N + WORKERS * own
            + -(-rows * 8 // 128) * 128)


@functools.lru_cache(maxsize=None)
def ffn_plan(k: int, f: int, sms: int = DEFAULT_SMS) -> dict:
    """Static work plan: fc1's chunk of K a multiple of a box's 64 rows,
    fc2's chunk of F a multiple of fc1's 128-column tiles (so an fc2 item
    waits on whole fc1 tiles), both as small as keep the items within the
    grid's workers; `slots` the boxes of the fullest worker, `smem` a
    block's shared memory but for the rows' statistics. Raises ValueError
    for widths whose weights do not fit the grid's shared memory or that
    the kernel does not hold."""
    if k % TILE_N or f % TILE_N or k > MAX_K or f > 4 * MAX_K:
        raise ValueError(f"ffn_block_int8: K {k} and F {f} must be "
                         f"multiples of {TILE_N}, K at most {MAX_K} and F "
                         f"at most {4 * MAX_K}")
    workers = WORKERS * sms
    p = dict(k=k, f=f, workers=workers,
             kc1=chunk_of_k(k, f, workers, BOX_K),
             kc2=chunk_of_k(f, k, workers, TILE_N))
    p["slots"] = max(boxes_per_worker(p))
    p["smem"] = smem_bytes(p, p["slots"], 0)
    if (p["slots"] > MAX_SLOTS or p["smem"] > SMEM_ALLOWED
            or p["kc1"] > MAX_KC1 or -(-k // p["kc1"]) > MAX_CHUNKS[0]
            or -(-f // p["kc2"]) > MAX_CHUNKS[1]):
        raise ValueError(f"ffn_block_int8: the weights at K {k}, F {f} do "
                         f"not fit the shared memory of {sms} blocks")
    return p


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def scratch_layout(rows: int, p: dict) -> Dict[str, Tuple[int, int]]:
    """(offset, length) in floats of each scratch segment, as
    csrc/ffn_int8.cu lays them out: the partial products of fc1's and fc2's
    chunks, h (bf16, half a float an element) and h's f32 row sums of each
    fc1 column tile (sum of h, sum of h^2)."""
    k, f = p["k"], p["f"]
    sizes = [("part1", -(-k // p["kc1"]) * rows * f),
             ("part2", -(-f // p["kc2"]) * rows * k),
             ("h", rows * f // 2), ("hstat", f // TILE_N * rows * 2)]
    out, o = {}, 0
    for name, n in sizes:
        out[name] = (o, n)
        o += _pad4(n)
    out["total"] = (0, o)
    return out


def counter_layout(p: dict) -> Dict[str, Tuple[int, int]]:
    """(offset, length) in ints of a stream's counters: a column tile's fc1
    products in (`cnt1`) and fc1 rows finished (`fin1`), a column tile's fc2
    products in (`cnt2`), the blocks done."""
    t1, t2 = p["f"] // TILE_N, p["k"] // TILE_N
    return {"cnt1": (0, t1), "fin1": (t1, t1), "cnt2": (2 * t1, t2),
            "done": (2 * t1 + t2, 1), "total": (0, 2 * t1 + t2 + 1)}


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("ffn_int8")
    lib.favae_ffn_int8.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.favae_ffn_int8.restype = ctypes.c_int
    lib.favae_ffn_int8_init.restype = ctypes.c_int
    lib.favae_ffn_int8_grid.argtypes = [ctypes.c_longlong]
    lib.favae_ffn_int8_grid.restype = ctypes.c_int
    lib.favae_ffn_int8_scratch.argtypes = [ctypes.c_int] * 5
    lib.favae_ffn_int8_scratch.restype = ctypes.c_longlong
    lib.favae_ffn_int8_counters.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.favae_ffn_int8_counters.restype = ctypes.c_int
    lib.favae_ffn_int8_smem.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.favae_ffn_int8_smem.restype = ctypes.c_longlong
    lib.favae_ffn_int8_items.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.favae_ffn_int8_items.restype = ctypes.c_int
    return lib


def kernel_layout(rows: int, p: dict) -> dict:
    """What the built library derives from the plan: its work items of both
    products, scratch floats, counter layout, boxes of the fullest worker
    and shared memory; chip_smoke.py holds them against the copies above."""
    lib = _library()
    args = (p["k"], p["f"], p["kc1"], p["kc2"], p["workers"])
    items = []
    for product in (0, 1):
        n = lib.favae_ffn_int8_items(*args, product, None, 0)
        buf = (ctypes.c_int * (5 * n))()
        lib.favae_ffn_int8_items(*args, product, buf, n)
        items.append([tuple(buf[5 * i:5 * i + 5]) for i in range(n)])
    fin1, cnt2, slots = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    total = lib.favae_ffn_int8_counters(p["k"], p["f"], ctypes.byref(fin1),
                                        ctypes.byref(cnt2))
    smem = lib.favae_ffn_int8_smem(rows, *args, ctypes.byref(slots))
    return {"items": items,
            "scratch": lib.favae_ffn_int8_scratch(rows, p["k"], p["f"],
                                                  p["kc1"], p["kc2"]),
            "counters": (fin1.value, cnt2.value, total),
            "slots": slots.value, "smem": smem}


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, smem: int) -> int:
    """Blocks of the cooperative grid on `device` (one an SM), with the
    kernel's shared-memory allowance set there first: once a device."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.favae_ffn_int8_init()
        grid = lib.favae_ffn_int8_grid(smem) if err == 0 else -err
    if grid < 1:
        raise RuntimeError(f"ffn_block_int8: no cooperative grid of blocks "
                           f"with {smem} bytes of shared memory on {device} "
                           f"(CUDA error or occupancy {grid})")
    return grid


def _arrived(device: torch.device, stream: int,
             capturing: bool) -> torch.Tensor:
    """The arrival counters of launches on one stream of `device`
    (`int8_matmul.stream_counters`)."""
    return stream_counters(_COUNTERS, "ffn_block_int8", device, stream,
                           capturing, COUNTERS)


def ffn_block_int8(x: torch.Tensor, gamma_in: torch.Tensor,
                   prep: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> torch.Tensor:
    """x (rows, K) bf16 -> LN(gamma_in) -> int8 fc1 -> GELU -> folded mid-LN
    -> int8 fc2 -> + x, (rows, K) bf16. `prep` from `prepare_ffn_weights`.
    On the card K and F must be multiples of 128, K at most 1536 and F at
    most 4 K's worth (6144), any row count."""
    if x.device.type == "cpu":
        return ffn_block_int8_plain(x, gamma_in, prep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_block_int8: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"ffn_block_int8: x {tuple(x.shape)} is not (rows, K)")
    rows, k = x.shape
    f = prep["w1q"].shape[1]
    shapes = {"w1q": (k, f), "s1": (1, f), "w2q": (f, k), "s2": (1, k),
              "c": (1, k)}
    for name, shape in shapes.items():
        if tuple(prep[name].shape) != shape:
            raise ValueError(f"ffn_block_int8: {name} {tuple(prep[name].shape)}"
                             f" != {shape}")
    if gamma_in.shape != (k,):
        raise ValueError("ffn_block_int8: gamma_in must be (K,)")
    check_cuda("ffn_block_int8", x.device,
               [(x, torch.bfloat16), (gamma_in, torch.float32),
                (prep["w1q"], torch.int8), (prep["w2q"], torch.int8)]
               + [(prep[n], torch.float32) for n in ("s1", "s2", "c")])
    # the kernel reads x and gamma_in in 16-byte pieces
    x_in = x if x.data_ptr() % 16 == 0 else x.clone()
    g_in = gamma_in if gamma_in.data_ptr() % 16 == 0 else gamma_in.clone()
    p = ffn_plan(k, f, sm_count(x.device))
    smem = smem_bytes(p, p["slots"], rows)
    if smem > SMEM_ALLOWED:
        raise ValueError(f"ffn_block_int8: {rows} rows' statistics do not "
                         "fit a block's shared memory")
    grid = _grid(x.device, smem)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _arrived(x.device, stream,
                        torch.cuda.is_current_stream_capturing())
    scratch = torch.empty((scratch_layout(rows, p)["total"][1],),
                          dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    err = launch_on(
        x.device, _library().favae_ffn_int8, x_in.data_ptr(), g_in.data_ptr(),
        prep["w1q"].data_ptr(), prep["s1"].data_ptr(), prep["w2q"].data_ptr(),
        prep["s2"].data_ptr(), prep["c"].data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), y.data_ptr(), rows, k, f, p["kc1"], p["kc2"],
        grid, eps, stream)
    if err != 0:
        raise RuntimeError(f"ffn_block_int8: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["ffn_int8"] += 1
    return y
