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
see the source. `prepare_fused_decode` keeps the JAX function's arithmetic
(the int8 values and scales are equal to its, since per-column quantisation
does not depend on tiling) but lays each matrix out whole, (L, K, N)
row-major, rather than as (L, T, d, w) tiles with `to_out` zero-padded.

`decode_step_fused` launches the kernel for CUDA tensors and takes the plain
PyTorch version, `decode_step_fused_plain`, only for CPU tensors. Both write
the cache row `pos` in place and return the same cache tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from favae_tpu_torch import _build
from favae_tpu_torch.config import GPTConfig
from favae_tpu_torch.ops.ffn_int8 import (folded_ffn_plain, layer_norm_rows,
                                          prepare_ffn_weights)
from favae_tpu_torch.ops.int8_matmul import (DEFAULT_SMS, check_cuda,
                                             chunk_of_k, quantize_weight,
                                             sm_count)

# kernel launches since the last reset; chip_smoke.py zeroes and reads it
LAUNCHES = {"decode_step": 0}

G = 8                # rows of one work item
DIM_HEAD = 64        # head width csrc/decode_step.cu is written for
BLOCKS_PER_SM = 2    # resident blocks asked of the cooperative grid
EPS = 1e-5
MAX_SLOTS = 4096     # kv slots whose scores fit the kernel's shared memory

_GRIDS: Dict[tuple, int] = {}


def plan(cfg: GPTConfig, sms: int = DEFAULT_SMS) -> dict:
    """Static work plan from the GPT config: widths and, for each of the
    four int8 products, the chunk of K one work item takes."""
    d = cfg.n_embed
    inner = cfg.n_head * cfg.dim_head
    f = 4 * d
    if d % 128 or inner % 4:
        raise ValueError(f"n_embed {d} must be a multiple of 128 and "
                         f"n_head * dim_head {inner} of 4")
    return dict(d=d, inner=inner, f=f,
                kc_q=chunk_of_k(d, inner, sms), kc_o=chunk_of_k(inner, d, sms),
                kc_1=chunk_of_k(d, f, sms), kc_2=chunk_of_k(f, d, sms))


def supports(cfg: GPTConfig, rows: int) -> bool:
    """Whether the fused kernel takes this config and row count.

    Kept from the JAX gate: `rows % 8` (work items are 8 rows), a head width
    the attention items are written for (here exactly 64, which all GPT
    presets have; the JAX gate was `dim_head % 64`), `d % 128`, and
    `inner <= d`. The last is not needed by this kernel (it multiplies
    `to_out` at its own depth instead of zero-padding it to d) but is kept
    so that `gpt2_large` goes on taking the FFN-only route and the two
    packages' routes stay comparable. Dropped: `w % dim_head == 0`, which
    only said that a Mosaic projection tile holds whole heads."""
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


def decode_step_fused_plain(x, pos: int, caches, cross_kv, cross_bias,
                            rel_rows, fused, cfg: GPTConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, rounding where it rounds:
    xn to bf16 before every projection, q to bf16 for q.k, probabilities to
    bf16 for p.v, the attention output to bf16 before the out projection,
    kv_t to bf16 into the cache, which the attention reads after the write;
    x in f32 throughout and to bf16 once at the end."""
    heads, dh = cfg.n_head, cfg.dim_head
    rows = x.shape[0]
    scale = dh ** -0.5
    fz = fused
    xs = x.float()

    def project(v, wq, s):  # bf16-rounded rows times int8, scale after
        return (v.bfloat16().float() @ wq.float()) * s.float()

    for l in range(cfg.n_layer):
        g = fz["norms"][l]
        xn = layer_norm_rows(xs, g[0], EPS).bfloat16()
        caches[l, :, pos] = (xn.float() @ fz["wkv"][l].float()).to(caches.dtype)
        q = (project(xn, fz["wq_s"][l], fz["sq_s"][l]) * scale).bfloat16()
        null = fz["null_s"][l].to(caches.dtype).expand(rows, 1, dh)
        kv = torch.cat([null, caches[l, :, : pos + 1]], dim=1)
        og = _attend_plain(q.reshape(rows, heads, dh), kv,
                           rel_rows[l][None, :, : pos + 2])
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
        [ctypes.c_void_p] * 24 + [ctypes.c_int] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.favae_decode_step.restype = ctypes.c_int
    lib.favae_decode_step_scratch.argtypes = [ctypes.c_int] * 8
    lib.favae_decode_step_scratch.restype = ctypes.c_longlong
    lib.favae_decode_step_grid.argtypes = [ctypes.c_int] * 8
    lib.favae_decode_step_grid.restype = ctypes.c_int
    return lib


_FUSED_DTYPES = {
    "wq_s": torch.int8, "wo_s": torch.int8, "wq_c": torch.int8,
    "wo_c": torch.int8, "w1q": torch.int8, "w2q": torch.int8,
    "wkv": torch.bfloat16}
_POINTER_ORDER = ("wq_s", "sq_s", "wo_s", "so_s", "wq_c", "sq_c", "wo_c",
                  "so_c", "wkv", "null_s", "norms", "w1q", "s1", "w2q", "s2",
                  "c2")


PHASES = ("q+kv", "self-attn", "out", "x+=LN", "cross q", "cross-attn",
          "cross out", "x+=LN,", "fc1", "fc2", "x+=ffn")  # of one layer


def decode_step_fused(x, pos: int, caches, cross_kv, cross_bias, rel_rows,
                      fused: Dict[str, torch.Tensor], cfg: GPTConfig,
                      phase_clock: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token step through all layers.

    x (rows, d) bf16; pos, a Python int; caches (L, rows, S, dh) bf16, whose
    row `pos` is WRITTEN IN PLACE (rows beyond `pos` are neither read nor
    trusted); cross_kv (L, rows, M, dh) bf16 with the null kv in slot 0;
    cross_bias (rows, M) f32 (0 / -1e9); rel_rows (L, H, S+1) f32, this
    position's rel-pos bias row per layer with column 0 the null's; `fused`
    from `prepare_fused_decode`. `phase_clock`, a CUDA int64 tensor of
    1 + 11 L entries, receives the device time in ns at which the set-up and
    then each phase (`PHASES`, layer by layer) ended. Returns (x_new,
    caches), `caches` being the tensor that was passed in."""
    if x.device.type == "cpu":
        return decode_step_fused_plain(x, pos, caches, cross_kv, cross_bias,
                                       rel_rows, fused, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"decode_step_fused: unsupported device {x.device}")
    rows, d = x.shape
    n_layer, heads, dh = cfg.n_layer, cfg.n_head, cfg.dim_head
    if not supports(cfg, rows):
        raise ValueError(f"decode_step_fused: config {cfg} with {rows} rows "
                         "is outside what the kernel takes (see supports)")
    seq, m_cross = caches.shape[2], cross_kv.shape[2]
    inner, f = heads * dh, 4 * d
    if not (caches.shape == (n_layer, rows, seq, dh)
            and cross_kv.shape == (n_layer, rows, m_cross, dh)
            and cross_bias.shape == (rows, m_cross)
            and rel_rows.shape == (n_layer, heads, seq + 1)
            and d == cfg.n_embed and 0 <= pos < seq
            and max(seq + 1, m_cross) <= MAX_SLOTS):
        raise ValueError(
            f"decode_step_fused: x {tuple(x.shape)}, caches "
            f"{tuple(caches.shape)}, cross_kv {tuple(cross_kv.shape)}, "
            f"cross_bias {tuple(cross_bias.shape)}, rel_rows "
            f"{tuple(rel_rows.shape)}, pos {pos} do not fit together")
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
            1 + len(PHASES) * n_layer,):
        raise ValueError("decode_step_fused: phase_clock must hold "
                         f"{1 + len(PHASES) * n_layer} entries")
    check_cuda("decode_step_fused", x.device,
               ([] if phase_clock is None else [(phase_clock, torch.int64)]) +
               [(x, torch.bfloat16), (caches, torch.bfloat16),
                (cross_kv, torch.bfloat16), (cross_bias, torch.float32),
                (rel_rows, torch.float32)]
               + [(fused[n], _FUSED_DTYPES.get(n, torch.float32))
                  for n in _POINTER_ORDER])
    p = plan(cfg, sm_count(x.device))
    kcs = (p["kc_q"], p["kc_o"], p["kc_1"], p["kc_2"])
    lib = _library()
    with torch.cuda.device(x.device):
        key = (x.device.index, d, seq, m_cross, kcs, BLOCKS_PER_SM)
        if key not in _GRIDS:
            _GRIDS[key] = lib.favae_decode_step_grid(d, seq, m_cross, *kcs,
                                                     BLOCKS_PER_SM)
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
            n_layer, rows, d, heads,
            seq, m_cross, f, pos, *kcs, EPS, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_step_fused: cooperative launch failed "
                           f"with CUDA error {err}")
    LAUNCHES["decode_step"] += 1
    return x_new, caches
