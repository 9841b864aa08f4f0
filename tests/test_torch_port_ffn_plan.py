"""Host side of the one-launch int8 FFN kernel (`csrc/ffn_int8.cu`), on the
CPU, at the widths of gpt2_large (K 1280) and gpt2_medium (K 1536) and at
the row counts a CFG batch gives it.

The kernel runs only on the card (`chip_smoke.py::check_ffn_int8`). The
chunks are Python (`ffn_plan`); which worker takes which item, where each
scratch segment and counter lies and how much shared memory a block takes
are the kernel's, and these tests hold Python copies of them (`work_items`,
`scratch_layout`, `counter_layout`, `smem_bytes`), which `chip_smoke.py`
compares with the built library's own (`ffn_int8.kernel_layout`). The last
tests run the kernel's order of arithmetic (partials of the chunks added in
ascending order, h's sums per 128-column tile) in plain PyTorch against
`ffn_block_int8_plain`; then the work counter (`WORK`, `launch_bytes`), and
on the card (`-m card --noconftest`) its count across a graph's replays.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from favae_tpu_torch.ops import ffn_int8 as fi

SMS = 132
WIDTHS = [1280, 1536]
ROWS = [2, 6, 8, 16, 24]
SMEM_SM = 233472     # shared memory of an H100 SM; a block reserves 1 KB
STATIC_SMEM = 2 * fi.MAX_SLOTS * 8 + 3 * 4   # the mbarriers, the election


def _plan(k):
    return fi.ffn_plan(k, 4 * k, SMS)


def _passes(rows):
    """The kernel's passes over a worker's boxes: (first row, rows, groups
    of 8 multiplied)."""
    return [(r0, min(fi.PASS, rows - r0), 2 if rows - r0 > 8 else 1)
            for r0 in range(0, rows, fi.PASS)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k", WIDTHS)
def test_items_cover_every_row_column_and_k_once(k, rows):
    p = _plan(k)
    for product, (depth, n) in enumerate(((k, 4 * k), (4 * k, k))):
        seen = np.zeros((rows, depth, n), dtype=np.int8)
        for t, c, w, k0, k1 in fi.work_items(p, product):
            assert 0 <= w < p["workers"]
            assert k0 % fi.BOX_K == 0 and 0 < k1 - k0 and k1 <= depth
            for r0, rv, nb in _passes(rows):
                assert rv <= 8 * nb <= fi.PASS
                seen[r0:r0 + rv, k0:k1, t * fi.TILE_N:(t + 1) * fi.TILE_N] += 1
        assert (seen == 1).all(), product


@pytest.mark.parametrize("k", WIDTHS)
def test_fc2_chunks_lie_on_whole_fc1_tiles(k):
    p = _plan(k)
    assert p["kc2"] % fi.TILE_N == 0 and p["kc1"] % fi.BOX_K == 0
    tiles1 = {t for t, *_ in fi.work_items(p, 0)}
    for _, _, _, f0, f1 in fi.work_items(p, 1):
        assert f0 % fi.TILE_N == 0 and f1 % fi.TILE_N == 0
        assert set(range(f0 // fi.TILE_N, f1 // fi.TILE_N)) <= tiles1


@pytest.mark.parametrize("k", WIDTHS)
def test_items_fill_the_workers_and_the_fc1_items_come_first(k):
    """At most one item of each product a worker, and enough of them that
    most of the card's SMs stream weights; fc1 from the first worker up, fc2
    from the last down, so a worker's fc1 item precedes its fc2 item."""
    p = _plan(k)
    for product in (0, 1):
        items = fi.work_items(p, product)
        workers = [w for _, _, w, _, _ in items]
        assert len(set(workers)) == len(items) <= p["workers"]
        assert len(items) >= 0.7 * p["workers"], (product, len(items))
    assert fi.work_items(p, 0)[0][2] == 0
    assert fi.work_items(p, 1)[0][2] == p["workers"] - 1


@pytest.mark.parametrize("k", WIDTHS)
def test_a_blocks_boxes_fit_its_shared_memory(k):
    """Worker w of block b is w = half * SMS + b; the whole layer's weights
    are held, every box in its own slot, beside the statistics of up to 256
    rows."""
    p = _plan(k)
    boxes = fi.boxes_per_worker(p)
    assert sum(boxes) * fi.BOX_K * fi.TILE_N == 2 * k * 4 * k
    assert max(boxes) == p["slots"] <= fi.MAX_SLOTS
    per_block = [boxes[b] + boxes[b + SMS] for b in range(SMS)]
    assert max(per_block) <= 2 * p["slots"]
    assert p["smem"] == fi.smem_bytes(p, p["slots"], 0)
    for rows in ROWS + [256]:
        assert fi.smem_bytes(p, p["slots"], rows) <= fi.SMEM_ALLOWED
    assert fi.SMEM_ALLOWED + STATIC_SMEM + 1024 <= SMEM_SM
    # the boxes, the activations of a pass of the longest chunk
    kc = max(p["kc1"], p["kc2"])
    assert p["smem"] >= 1024 + 2 * p["slots"] * 8192 + 2 * fi.PASS * kc * 2


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k", WIDTHS)
def test_scratch_and_counters_are_aligned_and_disjoint(k, rows):
    p = _plan(k)
    lay = fi.scratch_layout(rows, p)
    total = lay.pop("total")[1]
    spans = sorted(lay.values())
    for (o0, n0), (o1, _) in zip(spans, spans[1:]):
        assert o0 % 4 == 0 and o0 + n0 <= o1        # 16-byte aligned
    assert spans[-1][0] + spans[-1][1] <= total
    f = 4 * k
    assert lay["part1"][1] == -(-k // p["kc1"]) * rows * f
    assert lay["part2"][1] == -(-f // p["kc2"]) * rows * k
    assert lay["h"][1] * 2 == rows * f               # bf16
    assert lay["hstat"][1] == f // fi.TILE_N * rows * 2
    assert total * 4 < 8 << 20                       # stays in the L2
    cnt = fi.counter_layout(p)
    cspans = sorted(v for name, v in cnt.items() if name != "total")
    assert [o for o, _ in cspans] == [0] + list(np.cumsum(
        [n for _, n in cspans])[:-1])
    assert cnt["total"][1] == sum(n for _, n in cspans) <= fi.COUNTERS


@pytest.mark.parametrize("k,f", [(1280, 5000), (2176, 8704), (96, 384)])
def test_plan_refuses_what_the_kernel_does_not_hold(k, f):
    with pytest.raises(ValueError):
        fi.ffn_plan(k, f, SMS)


def test_plan_refuses_weights_beyond_the_grids_shared_memory():
    fi.ffn_plan(1536, 6144, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        fi.ffn_plan(1536, 6144, 66)


def _kernel_order(x, g_in, prep, p, eps=1e-5):
    """ffn_block_int8 in the kernel's order of arithmetic: LN_in rounded to
    bf16, each product as partials of its chunks added in ascending order,
    s1 and GELU on the sum, h's sums per fc1 column tile then over the tiles
    in order, the residual after the folded mid LayerNorm."""
    rows, k = x.shape
    f = p["f"]

    def chunked(v, w, kc):
        v = v.bfloat16().float()
        acc = torch.zeros(rows, w.shape[1])
        for k0 in range(0, w.shape[0], kc):
            acc = acc + v[:, k0:k0 + kc] @ w[k0:k0 + kc].float()
        return acc

    xn = fi.layer_norm_rows(x, g_in, eps)
    h = F.gelu(chunked(xn, prep["w1q"], p["kc1"]) * prep["s1"],
               approximate="tanh")
    tiles = h.reshape(rows, f // fi.TILE_N, fi.TILE_N)
    m1 = torch.zeros(rows, 1)
    m2 = torch.zeros(rows, 1)
    for t in range(f // fi.TILE_N):
        m1 = m1 + tiles[:, t].sum(-1, keepdim=True)
        m2 = m2 + (tiles[:, t] * tiles[:, t]).sum(-1, keepdim=True)
    mu = m1 / f
    inv = 1.0 / torch.sqrt(torch.clamp(m2 / f - mu * mu, min=0.0) + eps)
    acc = chunked(h, prep["w2q"], p["kc2"])
    return (x.float() + inv * (acc * prep["s2"] - mu * prep["c"])).bfloat16()


@pytest.mark.parametrize("k,rows", [(1280, 8), (1536, 6), (1280, 24)])
def test_kernel_order_matches_the_plain_version(k, rows):
    """Seeded random weights at a preset's width: within one bf16 rounding
    (2^-8) of each element plus 2^-9 of the largest; chip_smoke.py holds the
    kernel to 2^-7 plus 2^-9 of the largest."""
    p = _plan(k)
    rng = np.random.RandomState(7)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.randn(*s) * sc)
                                            .astype(np.float32))
    x = t(rows, k).bfloat16()
    g_in, g_mid = 1 + 0.1 * t(k), 1 + 0.1 * t(4 * k)
    prep = fi.prepare_ffn_weights(t(k, 4 * k, sc=0.05), g_mid,
                                  t(4 * k, k, sc=0.05))
    ours = _kernel_order(x, g_in, prep, p).float()
    ref = fi.ffn_block_int8_plain(x, g_in, prep).float()
    tol = 2.0 ** -8 * ref.abs() + 2.0 ** -9 * ref.abs().max()
    assert ((ours - ref).abs() <= tol).all()
    assert (ours != x.float()).float().mean() > 0.5   # the block did work


def _prep(k, seed=3):
    rng = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.randn(*s) * sc)
                                            .astype(np.float32))
    return (1 + 0.1 * t(k), fi.prepare_ffn_weights(
        t(k, 4 * k, sc=0.05), 1 + 0.1 * t(4 * k), t(4 * k, k, sc=0.05)))


@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("k", WIDTHS)
def test_launch_bytes_are_the_tensors_a_call_reads_and_writes(k, rows):
    """The prepared int8 weights, their scales and correction, gamma_in, x
    and y: 13.18 MB at gpt2_large's K 1280 and 8 rows (PERF.md's 3.94 us
    bound at 3.35 TB/s)."""
    g_in, prep = _prep(k)
    x = torch.zeros(rows, k, dtype=torch.bfloat16)
    want = (sum(t.numel() * t.element_size() for t in prep.values())
            + g_in.numel() * 4 + 2 * x.numel() * x.element_size())
    assert fi.launch_bytes(rows, k, 4 * k) == want
    if (k, rows) == (1280, 8):
        assert want == 13_184_000


def test_plain_path_counts_its_bytes_and_no_launch():
    g_in, prep = _prep(1280)
    x = torch.randn(6, 1280).bfloat16()
    before = fi.LAUNCHES["ffn_int8"], fi.WORK["bytes"]
    fi.ffn_block_int8(x, g_in, prep)
    fi.ffn_block_int8(x[:2], g_in, prep)
    assert fi.LAUNCHES["ffn_int8"] == before[0]
    assert fi.WORK["bytes"] - before[1] == (fi.launch_bytes(6, 1280, 5120)
                                            + fi.launch_bytes(2, 1280, 5120))


def test_work_counts_include_the_kernel():
    from favae_tpu_torch import graphs
    assert any(c is fi.LAUNCHES for c in graphs.launch_counts())
    assert graphs.work_counts()["ffn_int8"] is fi.WORK


# on the card (python -m pytest tests/test_torch_port_ffn_plan.py -m card
# --noconftest)

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_ffn_plan.py -m card "
                    "--noconftest)")
    return torch.device("cuda:0")


@pytest.mark.card
def test_sample_counts_launches_and_bytes_across_graph_replays(card):
    """`sample_tokens` on the int8 FFN route, attention wider than the
    residual as at gpt2_large (4 heads of 64 over 128), through
    `graphs.run_steps`: one launch a layer a token (the eager first and
    each replay) and `ffn_int8.bytes` exactly `launch_bytes` of each."""
    from favae_tpu_torch import config as tcfg
    from favae_tpu_torch.models.decode_engine import (quantize_decode_params,
                                                      sample_tokens)
    from favae_tpu_torch.models.gpt import GPT
    cfg = tcfg.GPTConfig(vocab_size=64, n_layer=2, n_embed=128, n_head=4,
                         dim_head=64, n_cond_embed=32, image_encoded_dim=4,
                         max_text_len=7, dropout=0.0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval().to(card)
    rng = np.random.RandomState(1)
    te = torch.from_numpy(rng.randn(4, 7, 32).astype(np.float32)).to(card)
    tm = torch.from_numpy(rng.rand(4, 7) > 0.2).to(card)
    tm[:, 0] = True
    qparams = quantize_decode_params(gpt)
    before = fi.LAUNCHES["ffn_int8"], fi.WORK["bytes"]
    with torch.inference_mode():
        grid = sample_tokens(cfg, gpt, te, tm, qparams=qparams, top_k=8,
                             generator=torch.Generator(card).manual_seed(2))
    torch.cuda.synchronize()
    assert grid.shape == (4, 4, 4)
    launches = fi.LAUNCHES["ffn_int8"] - before[0]
    assert launches == 16 * cfg.n_layer
    assert fi.WORK["bytes"] - before[1] == launches * fi.launch_bytes(
        8, 128, 512)
