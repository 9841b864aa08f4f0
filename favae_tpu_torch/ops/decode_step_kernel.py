"""Whole-decode-step CAT kernel: one token through all transformer layers
in one launch (kernel: `csrc/decode_step.cu`).

Port of `favae_tpu/ops/decode_step_kernel.py`. Per layer: LayerNorm, int8
q and out projections (per-column scales), bf16 kv projection, the KV-cache
write at `pos`, multi-query self-attention with the rel-pos bias row and the
null kv, cross-attention over the precomputed text kv with its mask, and the
int8 feed-forward with the mid LayerNorm folded as in `ops/ffn_int8.py`. The
hidden state is carried in f32 and leaves as bf16 once, after the last
layer. The sampling head (final norm, tied logits, CFG mixing, top-k/top-p,
gumbel) stays in PyTorch.

The step is bound by the bytes of every layer's weights. The CUDA kernel is
one persistent cooperative launch whose blocks deal each phase's work items
among themselves, with a barrier across the grid between dependent phases;
see the source. Its six int8 products run on the tensor cores over weight
boxes that TMA brings through 3-D tensor maps, each block being two workers
with a ring of `RING` boxes that is filled for the next product before the
barriers in between. `plan` picks each product's chunk of K. `work_items`,
`scratch_layout` and `smem_bytes` are copies of what the kernel derives
from it, for the CPU tests; `chip_smoke.py` holds them against the
library's own (`favae_decode_step_items`, `_scratch`, `_smem`).
`prepare_fused_decode` keeps the JAX function's
arithmetic (the int8 values and scales are equal to its, since per-column
quantisation does not depend on tiling) but lays each matrix out whole,
(L, K, N) row-major, rather than as (L, T, d, w) tiles with `to_out`
zero-padded.

`decode_step_fused` launches the kernel for CUDA tensors and takes the plain
PyTorch version, `decode_step_fused_plain`, only for CPU tensors. Both write
the cache row `pos` in place and return the same cache tensor. The position
is a 0-dim integer tensor on the device, as the TPU kernel's `() int32`, so
that one CUDA graph of a token step serves every position; the kernel reads
it at entry. A position outside [0, S) cannot be checked on the host without
a sync: the launch then adds one to a device error word and writes nothing,
and the caller reads the word once its loop is done (`check_positions`). A
Python int still works, is placed in such a tensor and is checked on the
host as well.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Dict, List, Optional, Tuple, Union

import torch

from favae_tpu_torch import _build
from favae_tpu_torch.config import GPTConfig
from favae_tpu_torch.ops.ffn_int8 import (folded_ffn_plain, layer_norm_rows,
                                          prepare_ffn_weights)
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, check_cuda,
                                             quantize_weight, sm_count)

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"decode_step": 0}
# the bytes the steps must stream (`step_bytes`) summed over the calls, the
# plain path's on the CPU too (`profiling.counters()`' `decode_step.bytes`)
WORK = {"bytes": 0.0}

Position = Union[int, torch.Tensor]   # a Python int or a 0-dim int tensor

G = 8                # rows of one work item
DIM_HEAD = 64        # head width csrc/decode_step.cu is written for
EPS = 1e-5
NEG_INF = -1e9       # the causal bias of a slot past the position
MAX_SLOTS = 4096     # kv slots whose scores fit the kernel's shared memory

# csrc/decode_step.cu
TILE_N = 128         # columns of a work item
BOX_K = 64           # rows of K in one TMA box
RING = 6             # boxes of a worker's ring
KC_MAX = RING * BOX_K  # the longest chunk of K: an item's boxes fit its ring
WORKERS = 2          # workers of 128 threads in a block of 256, one an SM
MAX_D = 32 * 256     # widths the row phases hold (32 columns a thread)
SMEM_ALLOWED = 160 * 1024  # dynamic shared memory of a block
SMEM_SM = 233472     # shared memory of an SM; a block reserves 1 KB of it

_GRIDS: Dict[tuple, int] = {}
_ERRORS: Dict[int, torch.Tensor] = {}   # a device's error word, () int32


def plan(cfg: GPTConfig, sms: int = DEFAULT_SMS) -> dict:
    """Static work plan from the GPT config: widths and, for each of the
    four int8 products, the chunk of K one work item takes: a multiple of
    the `BOX_K` rows of a TMA box, at most `KC_MAX` (the item's boxes all fit
    the ring, so a product's boxes can all be asked for before its barrier),
    and as many chunks as keep the items within the grid's workers (one
    item a worker: a second one would wait for its weights). Items are 128
    columns; where n_head * dim_head is not a multiple of 128, the q
    products' last tile is half empty."""
    d = cfg.n_embed
    inner = cfg.n_head * cfg.dim_head
    f = 4 * d
    if d % TILE_N or inner % BOX_K or d > MAX_D:
        raise ValueError(f"n_embed {d} must be a multiple of {TILE_N} and "
                         f"at most {MAX_D}, n_head * dim_head {inner} a "
                         f"multiple of {BOX_K}")
    workers = WORKERS * sms

    def kc(k, n):
        chunks = max(1, workers // -(-n // TILE_N))
        rows = -(-(-(-k // chunks)) // BOX_K) * BOX_K
        return max(BOX_K, min(rows, KC_MAX))
    return dict(d=d, inner=inner, f=f, kc_q=kc(d, inner), kc_o=kc(inner, d),
                kc_1=kc(d, f), kc_2=kc(f, d))


def products(p: dict) -> Dict[str, Tuple[int, int, int]]:
    """(K, N, chunk of K) of each int8 product of a layer, in the kernel's
    order."""
    d, inner, f = p["d"], p["inner"], p["f"]
    return {"q": (d, inner, p["kc_q"]), "out": (inner, d, p["kc_o"]),
            "cross q": (d, inner, p["kc_q"]), "cross out": (inner, d, p["kc_o"]),
            "fc1": (d, f, p["kc_1"]), "fc2": (f, d, p["kc_2"])}


def work_items(k: int, n: int, kc: int, rows: int) -> List[Tuple[int, ...]]:
    """The items of one (K, N) product in the kernel's order (column tile
    fastest, then chunk of K, then row group): (tile, chunk, group, k0,
    k1), rows k0..k1 of the layer's matrix and columns tile * TILE_N .. +
    TILE_N (past n in a ragged last tile). Worker w of W takes items w,
    w + W, ..."""
    tiles, nch = -(-n // TILE_N), -(-k // kc)
    out = []
    for it in range(tiles * nch * (rows // G)):
        t, c, g = it % tiles, it // tiles % nch, it // (tiles * nch)
        out.append((t, c, g, c * kc, min(k, (c + 1) * kc)))
    return out


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def scratch_layout(rows: int, p: dict) -> Dict[str, Tuple[int, int]]:
    """(offset, length) in floats of each scratch segment, as
    csrc/decode_step.cu lays them out (bf16 arrays take half a float an
    element; every offset 16-byte aligned)."""
    d, inner, f = p["d"], p["inner"], p["f"]
    nkq, nko = -(-d // p["kc_q"]), -(-inner // p["kc_o"])
    nk1, nk2 = -(-d // p["kc_1"]), -(-f // p["kc_2"])
    sizes = [("xst", rows * d), ("xn", rows * d // 2), ("ao", rows * inner // 2),
             ("h", rows * f // 2), ("part_q", nkq * rows * inner),
             ("part_kv", nkq * rows * DIM_HEAD), ("part_o", nko * rows * d),
             ("part1", nk1 * rows * f), ("part2", nk2 * rows * d),
             ("hstat", f // TILE_N * rows * 2),
             ("cnt", rows // G * (f // TILE_N))]
    out, o = {}, 0
    for name, n in sizes:
        out[name] = (o, n)
        o += _pad4(n)
    out["total"] = (0, o)
    return out


def _x_stride(kc: int) -> int:
    return kc + ((8 - kc % 64) + 64) % 64


def smem_bytes(d: int, seq: int, m_cross: int, kc_q: int) -> int:
    """Dynamic shared memory of a block, as csrc/decode_step.cu lays it out:
    1 KB to align the rings, two rings of `RING` 8 KB boxes, then the two
    workers' own regions (bf16 activations of a chunk and the fc1 finish's
    sums, or the kv items' f32 activations and warp sums), which the
    attention and row phases use as one region."""
    mma = 8 * _x_stride(KC_MAX) * 2 + 4 * G * 2 * 4
    kv = (kc_q * G + 4 * G * DIM_HEAD) * 4
    own = -(-max(mma, kv) // 128) * 128
    rows_phase = (d + 8) * 4
    attn = ((3 + 8) * DIM_HEAD + 8 + max(seq + 1, m_cross)) * 4
    return 1024 + WORKERS * RING * BOX_K * TILE_N + max(WORKERS * own,
                                                        rows_phase, attn)


def supports(cfg: GPTConfig, rows: int) -> bool:
    """Whether the fused kernel takes this config and row count.

    Kept from the JAX gate: `rows % 8` (work items are 8 rows), a head width
    the attention items are written for (here exactly 64, which all GPT
    presets have; the JAX gate was `dim_head % 64`), `d % 128`, and
    `inner <= d`. The last is not needed by this kernel (it multiplies
    `to_out` at its own depth instead of zero-padding it to d) but is kept
    so that `gpt2_large` goes on taking the FFN-only route and the two
    packages' routes stay comparable. Dropped: `w % dim_head == 0` and
    `d % w == 0`, which only said that a Mosaic projection tile holds whole
    heads and divides d. Added: `d <= MAX_D`, the widest row the row phases
    hold (the JAX gate has no bound)."""
    try:
        plan(cfg)
    except ValueError:
        return False
    return (rows % G == 0 and cfg.n_head * cfg.dim_head <= cfg.n_embed
            and cfg.dim_head == DIM_HEAD)


def prepare_fused_decode(gpt, cfg: GPTConfig = None) -> Dict[str, torch.Tensor]:
    """Quantise and stack every layer's projections of a `models.gpt.GPT`
    for the kernel: per-column int8 `to_q` and `to_out` of both attentions
    and `fc1`, the gamma_mid-folded int8 `fc2` with its colsum correction
    `c2`, bf16 self `to_kv`, f32 `null_kv` and the five LayerNorm scales.
    Matrices are (L, K, N) row-major, scales (L, 1, N)."""
    cfg = cfg or gpt.cfg
    plan(cfg)
    out: Dict[str, list] = {}

    def put(name, t):
        out.setdefault(name, []).append(t)

    for blk in gpt.blocks:
        sa, ca, ff = blk.self_attn, blk.cross_attn, blk.ff
        for tag, attn in (("s", sa), ("c", ca)):
            for key, lin in (("q", attn.to_q[1]), ("o", attn.to_out[1])):
                wq, s = quantize_weight(lin.weight.detach().T)
                put(f"w{key}_{tag}", wq)
                put(f"s{key}_{tag}", s)
        prep = prepare_ffn_weights(ff[1].weight.detach().T,
                                   ff[3].gamma.detach(),
                                   ff[4].weight.detach().T)
        for src, dst in (("w1q", "w1q"), ("s1", "s1"), ("w2q", "w2q"),
                         ("s2", "s2"), ("c", "c2")):
            put(dst, prep[src])
        put("wkv", sa.to_kv[1].weight.detach().T.bfloat16())
        put("null_s", sa.null_kv.detach().float()[None])
        put("norms", torch.stack([
            sa.norm.gamma, sa.to_out[2].gamma, ca.norm.gamma,
            ca.to_out[2].gamma, ff[0].gamma]).detach().float())
    return {k: torch.stack(v).contiguous() for k, v in out.items()}


def _attend_plain(q, kv, bias):
    """q (r, H, dh) bf16, kv (r, m, dh) bf16, bias broadcastable to
    (r, H, m) f32 -> (r, H*dh) bf16: f32 scores and softmax, the
    probabilities rounded to bf16 before p @ v."""
    scores = torch.einsum("rhd,rmd->rhm", q.float(), kv.float()) + bias
    p = torch.softmax(scores, dim=-1).bfloat16()
    og = torch.einsum("rhm,rmd->rhd", p.float(), kv.float())
    return og.bfloat16().reshape(q.shape[0], -1)


def decode_step_fused_plain(x, pos: Position, caches, cross_kv, cross_bias,
                            rel_rows, fused, cfg: GPTConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, rounding where it rounds:
    xn to bf16 before every projection, q to bf16 for q.k, probabilities to
    bf16 for p.v, the attention output to bf16 before the out projection,
    kv_t to bf16 into the cache, which the attention reads after the write;
    x in f32 throughout and to bf16 once at the end.

    With an int `pos` the attention takes the cache rows up to `pos`. With a
    0-dim tensor it takes the whole cache, as the JAX wrapper does
    (favae_tpu/ops/decode_step_kernel.py:355-358): slots past `pos + 1`
    (the null is slot 0) get the causal bias NEG_INF and their rows are read
    as zeros, and the row is written by `index_copy_`; no value reaches the
    host."""
    heads, dh = cfg.n_head, cfg.dim_head
    rows, seq = x.shape[0], caches.shape[2]
    scale = dh ** -0.5
    fz = fused
    xs = x.float()
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        at = pos.reshape(1).long()
        cols = torch.arange(seq + 1, device=x.device)
        visible = (cols <= at + 1) | (cols == 0)               # (S + 1,)
        causal = torch.where(visible, 0.0, NEG_INF)

    def project(v, wq, s):  # bf16-rounded rows times int8, scale after
        return (v.bfloat16().float() @ wq.float()) * s.float()

    for l in range(cfg.n_layer):
        g = fz["norms"][l]
        xn = layer_norm_rows(xs, g[0], EPS).bfloat16()
        kv_t = (xn.float() @ fz["wkv"][l].float()).to(caches.dtype)
        q = (project(xn, fz["wq_s"][l], fz["sq_s"][l]) * scale).bfloat16()
        null = fz["null_s"][l].to(caches.dtype).expand(rows, 1, dh)
        if on_device:
            caches[l].index_copy_(1, at, kv_t[:, None])
            kv = torch.where(visible[None, :, None],
                             torch.cat([null, caches[l]], dim=1), 0.0)
            bias = rel_rows[l][None] + causal
        else:
            caches[l, :, pos] = kv_t
            kv = torch.cat([null, caches[l, :, : pos + 1]], dim=1)
            bias = rel_rows[l][None, :, : pos + 2]
        og = _attend_plain(q.reshape(rows, heads, dh), kv, bias)
        of = project(og, fz["wo_s"][l], fz["so_s"][l])
        xs = xs + layer_norm_rows(of, g[1], EPS)

        xn = layer_norm_rows(xs, g[2], EPS).bfloat16()
        q = (project(xn, fz["wq_c"][l], fz["sq_c"][l]) * scale).bfloat16()
        og = _attend_plain(q.reshape(rows, heads, dh), cross_kv[l],
                           cross_bias[:, None, :])
        of = project(og, fz["wo_c"][l], fz["so_c"][l])
        xs = xs + layer_norm_rows(of, g[3], EPS)

        xs = xs + folded_ffn_plain(
            layer_norm_rows(xs, g[4], EPS), fz["w1q"][l], fz["s1"][l],
            fz["w2q"][l], fz["s2"][l], fz["c2"][l], EPS)
    return xs.to(x.dtype), caches


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("decode_step")
    lib.favae_decode_step.argtypes = (
        [ctypes.c_void_p] * 26 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.favae_decode_step.restype = ctypes.c_int
    lib.favae_decode_step_scratch.argtypes = [ctypes.c_int] * 8
    lib.favae_decode_step_scratch.restype = ctypes.c_longlong
    lib.favae_decode_step_grid.argtypes = [ctypes.c_int] * 4
    lib.favae_decode_step_grid.restype = ctypes.c_int
    lib.favae_decode_step_smem.argtypes = [ctypes.c_int] * 4
    lib.favae_decode_step_smem.restype = ctypes.c_longlong
    lib.favae_decode_step_items.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    lib.favae_decode_step_items.restype = ctypes.c_int
    lib.favae_decode_step_phases.restype = ctypes.c_int
    if lib.favae_decode_step_phases() != len(PHASES):
        raise RuntimeError(
            f"decode_step: the kernel has {lib.favae_decode_step_phases()} "
            f"phases a layer, PHASES names {len(PHASES)}")
    return lib


def kernel_items(k: int, n: int, kc: int, rows: int) -> List[Tuple[int, ...]]:
    """The kernel's own work items of a (K, N) product, as `work_items`
    gives them (needs the built library)."""
    lib = _library()
    count = lib.favae_decode_step_items(k, n, kc, rows, None, 0)
    buf = (ctypes.c_int * (5 * count))()
    lib.favae_decode_step_items(k, n, kc, rows, buf, count)
    return [tuple(buf[5 * i:5 * i + 5]) for i in range(count)]


_FUSED_DTYPES = {
    "wq_s": torch.int8, "wo_s": torch.int8, "wq_c": torch.int8,
    "wo_c": torch.int8, "w1q": torch.int8, "w2q": torch.int8,
    "wkv": torch.bfloat16}
_POINTER_ORDER = ("wq_s", "sq_s", "wo_s", "so_s", "wq_c", "sq_c", "wo_c",
                  "so_c", "wkv", "null_s", "norms", "w1q", "s1", "w2q", "s2",
                  "c2")


PHASES = ("q+kv", "self-attn", "out", "x+=LN", "cross q", "cross-attn",
          "cross out", "x+=LN,", "fc1", "fc2", "x+=ffn")  # of one layer


def _card(device) -> Optional[int]:
    """The index of a CUDA device ("cuda" alone: the current one); None
    for another device, which has no error word."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def _error_word(device: torch.device) -> torch.Tensor:
    """The device's error word, made at its first launch, which must not be
    one that a CUDA graph captures (the word would live in the graph's
    memory pool)."""
    word = _ERRORS.get(_card(device))
    if word is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_step_fused: the first launch on "
                               f"{device} is being captured; launch once "
                               "eagerly first")
        word = _ERRORS[_card(device)] = torch.zeros((), dtype=torch.int32,
                                                   device=device)
    return word


def position_errors(device) -> int:
    """Launches on `device` given a position outside [0, S) since the last
    call, each of which wrote nothing; sets the count back to 0. Reads the
    device (a host sync): call it after a loop, outside any capture."""
    word = _ERRORS.get(_card(device))
    if word is None:
        return 0
    n = int(word.item())
    if n:
        word.zero_()
    return n


def check_positions(device) -> None:
    """Raise if a launch on `device` was given a position outside [0, S)
    since the last check."""
    n = position_errors(device)
    if n:
        raise RuntimeError(f"decode_step_fused: {n} launch(es) on {device} "
                           "were given a position outside [0, S) and wrote "
                           "nothing")


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_bytes(x, pos: Position, caches, cross_kv, cross_bias, rel_rows,
               fused: Dict[str, torch.Tensor]) -> float:
    """The bytes one step must stream, as row 6's bound counts them: x read
    and x_new written, the cross K/V, its bias and the position's rel-pos
    rows, every prepared tensor of `fused` (int8 weights, their scales, the
    bf16 `to_kv`, the norms) and the self-attention cache's rows up to the
    position. The position of a 0-dim tensor is not known on the host: its
    rows are counted at the mean over a full sweep of the S positions,
    (S + 1) / 2, so that a loop over all of them counts what they read."""
    layers, rows, seq, dh = caches.shape
    cache_rows = ((seq + 1) / 2 if isinstance(pos, torch.Tensor)
                  else operator.index(pos) + 1)
    return (2 * _nbytes(x) + _nbytes(cross_kv, cross_bias, rel_rows)
            + _nbytes(*fused.values())
            + layers * rows * dh * caches.element_size() * cache_rows)


def decode_step_fused(x, pos: Position, caches, cross_kv, cross_bias,
                      rel_rows, fused: Dict[str, torch.Tensor],
                      cfg: GPTConfig,
                      phase_clock: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token step through all layers.

    x (rows, d) bf16; pos, a 0-dim int64 or int32 tensor on x's device, or a
    Python int (checked here and placed in such a tensor); caches (L, rows,
    S, dh) bf16, whose row `pos` is WRITTEN IN PLACE (rows beyond `pos` are
    neither read nor trusted); a tensor `pos` outside [0, S) makes the
    launch count an error (`check_positions`) and write nothing, neither the
    cache row nor x_new; cross_kv (L, rows, M, dh) bf16 with the null kv in
    slot 0; cross_bias (rows, M) f32 (0 / -1e9); rel_rows (L, H, S+1) f32, this
    position's rel-pos bias row per layer with column 0 the null's; `fused`
    from `prepare_fused_decode`. `phase_clock`, a CUDA int64 tensor of
    2 (1 + 11 L) entries, zero before the call, receives device times in
    ns: first when block 0 passed the grid barrier after the set-up and
    after each phase (`PHASES`, layer by layer), then the latest time a
    block reached each of those barriers. Returns (x_new, caches), `caches`
    being the tensor that was passed in."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_step_fused: unsupported device {x.device}")
    seq = caches.shape[2]
    if isinstance(pos, torch.Tensor):
        if (pos.dim() != 0 or pos.device != x.device
                or pos.dtype not in (torch.int32, torch.int64)):
            raise ValueError("decode_step_fused: pos must be a 0-dim int32 "
                             f"or int64 tensor on {x.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")
    elif not 0 <= operator.index(pos) < seq:
        raise ValueError(f"decode_step_fused: pos {pos} outside [0, {seq})")
    if x.device.type == "cpu":
        WORK["bytes"] += step_bytes(x, pos, caches, cross_kv, cross_bias,
                                    rel_rows, fused)
        return decode_step_fused_plain(x, pos, caches, cross_kv, cross_bias,
                                       rel_rows, fused, cfg)
    rows, d = x.shape
    n_layer, heads, dh = cfg.n_layer, cfg.n_head, cfg.dim_head
    if not supports(cfg, rows):
        raise ValueError(f"decode_step_fused: config {cfg} with {rows} rows "
                         "is outside what the kernel takes (see supports)")
    m_cross = cross_kv.shape[2]
    inner, f = heads * dh, 4 * d
    if not (caches.shape == (n_layer, rows, seq, dh)
            and cross_kv.shape == (n_layer, rows, m_cross, dh)
            and cross_bias.shape == (rows, m_cross)
            and rel_rows.shape == (n_layer, heads, seq + 1)
            and d == cfg.n_embed and max(seq + 1, m_cross) <= MAX_SLOTS):
        raise ValueError(
            f"decode_step_fused: x {tuple(x.shape)}, caches "
            f"{tuple(caches.shape)}, cross_kv {tuple(cross_kv.shape)}, "
            f"cross_bias {tuple(cross_bias.shape)}, rel_rows "
            f"{tuple(rel_rows.shape)} do not fit together")
    expect = {"wq_s": (d, inner), "wo_s": (inner, d), "wq_c": (d, inner),
              "wo_c": (inner, d), "w1q": (d, f), "w2q": (f, d), "wkv": (d, dh),
              "sq_s": (1, inner), "so_s": (1, d), "sq_c": (1, inner),
              "so_c": (1, d), "s1": (1, f), "s2": (1, d), "c2": (1, d),
              "null_s": (1, dh), "norms": (5, d)}
    for name, shape in expect.items():
        if tuple(fused[name].shape) != (n_layer,) + shape:
            raise ValueError(f"decode_step_fused: fused[{name!r}] "
                             f"{tuple(fused[name].shape)} != "
                             f"{(n_layer,) + shape}")
    if phase_clock is not None and phase_clock.shape != (
            2 * (1 + len(PHASES) * n_layer),):
        raise ValueError("decode_step_fused: phase_clock must hold "
                         f"{2 * (1 + len(PHASES) * n_layer)} entries")
    check_cuda("decode_step_fused", x.device,
               ([] if phase_clock is None else [(phase_clock, torch.int64)]) +
               [(x, torch.bfloat16), (caches, torch.bfloat16),
                (cross_kv, torch.bfloat16), (cross_bias, torch.float32),
                (rel_rows, torch.float32)]
               + [(fused[n], _FUSED_DTYPES.get(n, torch.float32))
                  for n in _POINTER_ORDER])
    p = plan(cfg, sm_count(x.device))
    kcs = (p["kc_q"], p["kc_o"], p["kc_1"], p["kc_2"])
    streamed = step_bytes(x, pos, caches, cross_kv, cross_bias, rel_rows,
                          fused)
    lib = _library()
    with torch.cuda.device(x.device):
        error = _error_word(x.device)
        pos = (pos.long() if isinstance(pos, torch.Tensor) else
               torch.full((), pos, dtype=torch.int64, device=x.device))
        key = (x.device.index, d, seq, m_cross, p["kc_q"])
        if key not in _GRIDS:
            _GRIDS[key] = lib.favae_decode_step_grid(d, seq, m_cross,
                                                     p["kc_q"])
        grid = _GRIDS[key]
        if grid < 1:
            raise RuntimeError("decode_step_fused: no block of the kernel "
                               f"fits an SM (occupancy query gave {grid})")
        scratch = torch.empty(
            (lib.favae_decode_step_scratch(rows, d, heads, f, *kcs),),
            dtype=torch.float32, device=x.device)
        x_new = torch.empty_like(x)
        err = lib.favae_decode_step(
            x.data_ptr(), caches.data_ptr(), cross_kv.data_ptr(),
            cross_bias.data_ptr(), rel_rows.data_ptr(),
            *[fused[n].data_ptr() for n in _POINTER_ORDER],
            x_new.data_ptr(), scratch.data_ptr(),
            None if phase_clock is None else phase_clock.data_ptr(),
            pos.data_ptr(), error.data_ptr(), n_layer, rows, d, heads,
            seq, m_cross, f, *kcs, EPS, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step_fused: cooperative launch failed "
                           f"with CUDA error {err}")
    LAUNCHES["decode_step"] += 1
    WORK["bytes"] += streamed
    return x_new, caches
