"""Host side of the whole-step decode kernel (`csrc/decode_step.cu`), on the
CPU, at the gpt2_medium and gpt2_mini shapes and at a width with a ragged
last column tile and rows wider than 2048.

The kernel runs only on the card (`chip_smoke.py::check_decode_step`). The
chunk of K of each product is Python (`plan`); which worker reads which
weight rows, where each scratch segment lies and how much shared memory a
block takes are the kernel's, and these tests hold Python copies of them
(`work_items`, `scratch_layout`, `smem_bytes`), which `chip_smoke.py`
compares with the built library's own. The last test runs the kernel's
order of arithmetic (partial products of the chunks of K added in
ascending order, h's sums taken per 128-column tile) in plain PyTorch
against `decode_step_fused_plain`.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from favae_tpu_torch import config as C
from favae_tpu_torch.ops import decode_step_kernel as dk
from favae_tpu_torch.ops.ffn_int8 import layer_norm_rows

SMS = 132
PRESETS = ["gpt2_medium", "gpt2_mini"]
# 3 heads: a q product of 192 columns, its last tile half empty; d 2304:
# rows wider than the 2048 columns the row phases hold 8 a thread
RAGGED = "d2304_h3"
SEQ, M_CROSS = 256, 78
STATIC_SMEM = 2 * dk.RING * 8 + 2 * 4   # the mbarriers and the fc1 flags


def _cfg(name, **kw):
    if name == RAGGED:
        return C.GPTConfig(vocab_size=1024, n_embed=2304, n_head=3, **kw)
    return dataclasses.replace(getattr(C, name)(vocab_size=1024), **kw)


def _plan(name):
    return dk.plan(_cfg(name), SMS)


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("name", PRESETS + [RAGGED])
def test_items_cover_every_row_column_and_k_once(name, rows):
    for prod, (k, n, kc) in dk.products(_plan(name)).items():
        tiles = -(-n // dk.TILE_N)
        seen = np.zeros((rows // dk.G, k, tiles * dk.TILE_N), dtype=int)
        for t, c, g, k0, k1 in dk.work_items(k, n, kc, rows):
            assert k0 == c * kc and k0 % dk.BOX_K == 0, prod
            # whole boxes, inside the layer's K rows
            assert 0 < k1 - k0 <= dk.KC_MAX and (k1 - k0) % dk.BOX_K == 0
            assert k1 <= k and t < tiles
            seen[g, k0:k1, t * dk.TILE_N:(t + 1) * dk.TILE_N] += 1
        assert (seen == 1).all(), prod


@pytest.mark.parametrize("d,heads,dim_head",
                         [(dk.MAX_D + 128, 16, 64), (1600, 16, 64),
                          (1536, 3, 32)])
def test_plan_refuses_what_the_kernel_does_not_hold(d, heads, dim_head):
    """Rows of at most MAX_D columns (32 a thread), d a multiple of the
    128 columns of a work item, n_head * dim_head of the 64 of a head."""
    cfg = C.GPTConfig(vocab_size=64, n_layer=1, n_embed=d, n_head=heads,
                      dim_head=dim_head)
    with pytest.raises(ValueError):
        dk.plan(cfg, SMS)
    assert not dk.supports(cfg, 8)


# (n_embed, n_head, dim_head): whether the JAX package's gate sends it to its
# fused kernel, and whether the port's does
_GATES = [
    ((1536, 16, 64), True, True),      # gpt2_medium
    ((1536, 24, 64), True, True),      # gpt2_mini
    ((1280, 32, 64), False, False),    # gpt2_large: inner > d
    ((1536, 3, 64), True, True),       # a 192-column q, last tile half empty
    ((2304, 3, 64), True, True),       # and rows wider than 2048
    ((2560, 8, 64), True, True),
    ((8192, 16, 64), True, True),
    ((1600, 16, 64), False, False),    # d % 128
    # the port is narrower: heads of 128 (its attention items are 64 wide),
    # rows wider than MAX_D
    ((1536, 8, 128), True, False),
    ((8704, 16, 64), True, False),
    # and wider: a Mosaic tile of min(512, inner) columns must divide d
    ((768, 12, 64), False, True),
]


@pytest.mark.parametrize("shape,jax_fused,port_fused", _GATES)
def test_gate_against_the_jax_package(shape, jax_fused, port_fused):
    from favae_tpu.ops import decode_step_kernel as jax_dk
    d, heads, dim_head = shape
    cfg = C.GPTConfig(vocab_size=64, n_layer=1, n_embed=d, n_head=heads,
                      dim_head=dim_head)
    assert jax_dk.supports(cfg, 8) == jax_fused
    assert dk.supports(cfg, 8) == port_fused
    assert not dk.supports(cfg, 12)


@pytest.mark.parametrize("name", PRESETS)
def test_chunks_are_whole_boxes_and_fill_the_card(name):
    p = _plan(name)
    workers = dk.WORKERS * SMS
    for prod, (k, n, kc) in dk.products(p).items():
        assert kc % dk.BOX_K == 0 and dk.BOX_K <= kc <= dk.KC_MAX, prod
        items = len(dk.work_items(k, n, kc, 8))
        # one item a worker at most, and more items than SMs: the ring of
        # every worker holds its whole item, asked for before the barrier
        assert SMS <= items <= workers, (prod, items)
        if prod.startswith("fc"):                  # 9.4 MB: most workers
            assert items >= 0.9 * workers, (prod, items)


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("name", PRESETS + [RAGGED])
def test_scratch_segments_are_aligned_and_disjoint(name, rows):
    p = _plan(name)
    lay = dk.scratch_layout(rows, p)
    total = lay.pop("total")[1]
    spans = sorted(lay.values())
    for (o0, n0), (o1, _) in zip(spans, spans[1:]):
        assert o0 % 4 == 0 and o0 + n0 <= o1        # 16-byte aligned
    assert spans[-1][0] + spans[-1][1] <= total
    d, inner, f = p["d"], p["inner"], p["f"]
    # bf16 activations take half a float an element
    assert lay["xn"][1] * 2 == rows * d and lay["ao"][1] * 2 == rows * inner
    assert lay["h"][1] * 2 == rows * f
    assert lay["part1"][1] == -(-d // p["kc_1"]) * rows * f
    assert lay["hstat"][1] == f // dk.TILE_N * rows * 2
    assert total * 4 < 16 << 20                      # stays in the L2


@pytest.mark.parametrize("slots", [(SEQ, M_CROSS), (dk.MAX_SLOTS - 1, 77),
                                   (16, dk.MAX_SLOTS)])
@pytest.mark.parametrize("name", PRESETS + [RAGGED])
def test_shared_memory_fits_the_blocks_of_an_sm(name, slots):
    p = _plan(name)
    smem = dk.smem_bytes(p["d"], *slots, p["kc_q"])
    assert smem <= dk.SMEM_ALLOWED
    assert dk.smem_bytes(dk.MAX_D, *slots, dk.KC_MAX) <= dk.SMEM_ALLOWED
    # one block an SM
    assert dk.SMEM_ALLOWED + STATIC_SMEM + 1024 <= dk.SMEM_SM
    # the rings, and a region for a worker's chunk or the attention scores
    assert smem >= 1024 + 2 * dk.RING * 8192 + 4 * max(slots)


def _kernel_order(x, pos, caches, cross_kv, cross_bias, rel_rows, fz, cfg,
                  p):
    """decode_step_fused in the kernel's order of arithmetic: each product
    as partials of its chunks of K added in ascending order, the scale after
    the sum; h's sums per column tile of fc1, then over the tiles."""
    heads, dh = cfg.n_head, cfg.dim_head
    rows, f = x.shape[0], p["f"]

    def chunked(v, w, kc):
        v = v.bfloat16().float()
        acc = torch.zeros(rows, w.shape[1])
        for k0 in range(0, w.shape[0], kc):
            acc = acc + v[:, k0:k0 + kc] @ w[k0:k0 + kc].float()
        return acc

    def attend(q, kv, bias):
        s = torch.einsum("rhd,rmd->rhm", q.float(), kv.float()) + bias
        pr = torch.softmax(s, dim=-1).bfloat16().float()
        return torch.einsum("rhm,rmd->rhd", pr, kv.float()).bfloat16()

    xs = x.float()
    for l in range(cfg.n_layer):
        g = fz["norms"][l]
        for br, (wq, sq, wo, so) in enumerate(
                (("wq_s", "sq_s", "wo_s", "so_s"),
                 ("wq_c", "sq_c", "wo_c", "so_c"))):
            xn = layer_norm_rows(xs, g[2 * br], dk.EPS).bfloat16()
            q = (chunked(xn, fz[wq][l], p["kc_q"]) * fz[sq][l] * dh ** -0.5
                 ).bfloat16().reshape(rows, heads, dh)
            if br == 0:
                caches[l, :, pos] = chunked(xn, fz["wkv"][l],
                                            p["kc_q"]).bfloat16()
                null = fz["null_s"][l].bfloat16().expand(rows, 1, dh)
                kv = torch.cat([null, caches[l, :, :pos + 1]], dim=1)
                og = attend(q, kv, rel_rows[l][None, :, :pos + 2])
            else:
                og = attend(q, cross_kv[l], cross_bias[:, None, :])
            of = chunked(og.reshape(rows, -1), fz[wo][l], p["kc_o"]) * fz[so][l]
            xs = xs + layer_norm_rows(of, g[2 * br + 1], dk.EPS)
        xn = layer_norm_rows(xs, g[4], dk.EPS).bfloat16()
        h = F.gelu(chunked(xn, fz["w1q"][l], p["kc_1"]) * fz["s1"][l],
                   approximate="tanh")
        tiles = h.reshape(rows, f // dk.TILE_N, dk.TILE_N)
        m1, m2 = tiles.sum(-1).sum(-1, keepdim=True), \
            (tiles * tiles).sum(-1).sum(-1, keepdim=True)
        mu = m1 / f
        inv = torch.rsqrt(torch.clamp(m2 / f - mu * mu, min=0.0) + dk.EPS)
        acc = chunked(h, fz["w2q"][l], p["kc_2"])
        xs = xs + inv * (acc * fz["s2"][l] - mu * fz["c2"][l])
    return xs.bfloat16()


@pytest.mark.parametrize("name,pos", [("gpt2_medium", 0), ("gpt2_medium", 37),
                                      (RAGGED, 5)])
def test_kernel_order_matches_the_plain_version(name, pos):
    """A preset's widths at 2 layers and 64 positions, seeded random
    weights: within one bf16 rounding of each element plus 2^-7 of the
    largest, the tolerance chip_smoke.py holds the kernel to."""
    cfg = _cfg(name, n_layer=2)
    p = dk.plan(cfg, SMS)
    d, inner, f, L, dh = p["d"], p["inner"], p["f"], cfg.n_layer, cfg.dim_head
    rng = np.random.RandomState(3)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rng.randn(*s) * sc).astype(np.float32))
    q8 = lambda *s: torch.from_numpy(rng.randint(-127, 128, s).astype(np.int8))
    fz = {"wq_s": q8(L, d, inner), "wo_s": q8(L, inner, d),
          "wq_c": q8(L, d, inner), "wo_c": q8(L, inner, d),
          "w1q": q8(L, d, f), "w2q": q8(L, f, d),
          "sq_s": t(L, 1, inner, sc=1e-3).abs(), "so_s": t(L, 1, d, sc=1e-3).abs(),
          "sq_c": t(L, 1, inner, sc=1e-3).abs(), "so_c": t(L, 1, d, sc=1e-3).abs(),
          "s1": t(L, 1, f, sc=1e-3).abs(), "s2": t(L, 1, d, sc=1e-3).abs(),
          "c2": t(L, 1, d, sc=0.1), "wkv": t(L, d, dh, sc=0.03).bfloat16(),
          "null_s": t(L, 1, dh), "norms": 1 + 0.1 * t(L, 5, d)}
    seq, rows = 64, 8
    x = t(rows, d).bfloat16()
    caches = t(L, rows, seq, dh).bfloat16()
    cross_kv = t(L, rows, M_CROSS, dh).bfloat16()
    cross_bias = torch.zeros(rows, M_CROSS)
    cross_bias[rows // 2:, 1:] = -1e9
    rel = t(L, cfg.n_head, seq + 1)
    args = (cross_kv, cross_bias, rel, fz, cfg)
    ref, ref_cache = dk.decode_step_fused_plain(x, pos, caches.clone(), *args)
    ours_cache = caches.clone()
    ours = _kernel_order(x, pos, ours_cache, *args, p)
    for a, b in ((ours, ref), (ours_cache[:, :, pos], ref_cache[:, :, pos])):
        a, b = a.float(), b.float()
        tol = 2.0 ** -7 * (b.abs() + b.abs().max())
        assert ((a - b).abs() <= tol).all()
    assert ours.float().abs().max() > 1.0
