"""The token step's projections in one hand-written launch each
(`favae_tpu_torch/ops/rows_gemm.py`, `csrc/rows_gemm.cu`, taken by
`models/gpt.py`'s `Dense.forward`).

On the CPU: the plain version against `F.linear` at every projection of
gpt2_medium and gpt2_large, whole and at their tp=2 halves, for 1, 8, 16
and 64 rows, within a bound derived from K (the sums' order and one bf16
rounding each); a plain emulation of the kernel's cut of K (`plan`: each
rank's chunk, its k-steps of 16 in two accumulators, the ranks added in
ascending order) within the same bound of the plain version; `plan` itself
(the cluster, the chunks, the shared memory, what it refuses); and
`Dense.forward`'s route: the kernel only for a CUDA input with the cast
weight in bf16, at most 16 rows and K a multiple of 8, `F.linear` for
everything else, and no launch counted on the CPU. The `card` cases hold the
kernel to the plain version at the same shapes, hold `Plan.smem()` to the
library's count, and count its launches across a CUDA-graph replay of
`GPT.sample` (seven a layer a token). This
file imports no JAX (on the card: python -m pytest
tests/test_torch_port_rows_gemm.py -m card --noconftest).
"""

import ctypes
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from favae_tpu_torch import _build
from favae_tpu_torch import config as tcfg
from favae_tpu_torch import graphs
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.models.gpt import GPT, Dense
from favae_tpu_torch.ops import rows_gemm


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/torch_threads.py gives other files
    (not imported: under --noconftest on the card `tests` is not a package
    the run can import)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projections(cfg, tp=1):
    """(K, N) of the seven products of a token step's layer, this rank's
    slice at tp: self-attention to_q, to_kv, to_out; cross-attention to_q,
    to_out; fc1, fc2 (to_q and fc1 split by output, to_out and fc2 by
    input; the one K/V head whole)."""
    d, inner, ff = cfg.n_embed, cfg.n_head * cfg.dim_head, 4 * cfg.n_embed
    q, out = (d, inner // tp), (inner // tp, d)
    return {"to_q": q, "to_kv": (d, cfg.dim_head), "to_out": out,
            "cross.to_q": q, "cross.to_out": out,
            "fc1": (d, ff // tp), "fc2": (ff // tp, d)}


MODELS = {f"{name}/tp{tp}": _projections(getattr(tcfg, name)(1024), tp)
          for name in ("gpt2_medium", "gpt2_large") for tp in (1, 2)}
ROWS = (1, 8, 16, 64)


@functools.lru_cache(maxsize=None)
def _weight(k, n):
    rng = np.random.RandomState(k * 7 + n)
    return torch.from_numpy((0.02 * rng.randn(n, k)).astype(
        np.float32)).bfloat16()


def _x(rows, k, seed=0):
    rng = np.random.RandomState(seed + rows)
    return torch.from_numpy(rng.randn(rows, k).astype(np.float32)).bfloat16()


def sum_bound(x, w, want):
    """What two f32 sums of the same bf16 products, in any two orders, each
    rounded once to bf16, may differ by: each sum within K eps32 of the
    sum of |products|, and one bf16 rounding of the output each."""
    k = x.shape[-1]
    mags = x.float().abs() @ w.float().abs().t()
    return (torch.finfo(torch.bfloat16).eps * want.float().abs()
            + 2 * k * torch.finfo(torch.float32).eps * mags)


def within(got, want, x, w):
    return bool(((got.float() - want.float()).abs()
                 <= sum_bound(x, w, want)).all())


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("model", MODELS)
def test_plain_version_is_f_linear_within_the_sums_order(model, rows):
    for name, (k, n) in MODELS[model].items():
        w, x = _weight(k, n), _x(rows, k)
        got = rows_gemm.rows_linear_plain(x, w)
        want = F.linear(x, w)
        assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
        assert within(got, want, x, w), name


def split_sum(x, w, p):
    """The kernel's sum in plain PyTorch under plan `p`: rank r adds its
    chunk [r kc, (r + 1) kc) in k-steps of 16, even and odd steps in two
    f32 accumulators added at the end; the ranks' partials are added in
    ascending order and rounded once to bf16."""
    k = x.shape[-1]
    xf, wf = x.float(), w.float()
    total = None
    for r in range(p.ranks):
        acc = [torch.zeros(x.shape[0], w.shape[0]) for _ in range(2)]
        for i, k0 in enumerate(range(r * p.kc, min(k, (r + 1) * p.kc), 16)):
            acc[i % 2] += xf[:, k0:k0 + 16] @ wf[:, k0:k0 + 16].t()
        part = acc[0] + acc[1]
        total = part if total is None else total + part
    return total.bfloat16()


@pytest.mark.parametrize("rows", (1, 8, 16))
@pytest.mark.parametrize("model", ["gpt2_medium/tp1", "gpt2_large/tp2"])
def test_the_kernels_split_of_k_is_the_plain_version_within_the_bound(
        model, rows):
    for name, (k, n) in MODELS[model].items():
        w, x = _weight(k, n), _x(rows, k, seed=3)
        got = split_sum(x, w, rows_gemm.plan(rows, k, n))
        assert within(got, rows_gemm.rows_linear_plain(x, w), x, w), name


@pytest.mark.parametrize("model", MODELS)
def test_plan_fills_the_card_and_covers_k(model):
    """Every product at every row count puts four blocks an SM on the
    card, or a cluster of 8, or a stage a rank; the chunks are whole stages that
    cover K, every rank but the last holds one (K = 1280 over 8 ranks of 3
    stages leaves the last empty: the same time as 8 chunks of 160 depths,
    whose last stages would each read 32 depths of the next chunk), and a
    block's shared memory fits."""
    for name, (k, n) in MODELS[model].items():
        for rows in range(1, rows_gemm.MAX_ROWS + 1):
            p = rows_gemm.plan(rows, k, n)
            ranks, tiles = p.ranks, -(-n // rows_gemm.TN)
            assert p.nb == (1 if rows <= 8 else 2)
            assert p.kc % rows_gemm.SK == 0 and p.ranks * p.kc >= k
            assert (p.ranks - 2) * p.kc < k, (name, p)
            assert p.ranks in (1, 2, 4, 8)
            assert ranks * tiles >= 4 * 132 or p.ranks == 8 or (
                k < rows_gemm.SK * 2 * p.ranks), (name, p)
            assert p.smem() <= 232448 - rows_gemm.STATIC_SMEM
            assert 1 <= p.depth <= min(p.kc // rows_gemm.SK,
                                       rows_gemm.MAX_DEPTH)
            assert p.resident(132) >= ranks * tiles, (name, p)


def test_plan_of_the_token_steps_products():
    """gpt2_medium's seven products at 8 rows: the cluster along K, the
    chunk and the ring of each (fc2's chunk twice its ring)."""
    got = {name: tuple(rows_gemm.plan(8, k, n))
           for name, (k, n) in MODELS["gpt2_medium/tp1"].items()}
    assert got == {"to_q": (1, 8, 192, 3), "to_kv": (1, 8, 192, 3),
                   "to_out": (1, 8, 128, 2), "cross.to_q": (1, 8, 192, 3),
                   "cross.to_out": (1, 8, 128, 2), "fc1": (1, 8, 192, 3),
                   "fc2": (1, 8, 768, 6)}


@pytest.mark.parametrize("rows,k", [(0, 64), (17, 64), (16, 1 << 17)])
def test_plan_refuses_what_the_kernel_does_not_take(rows, k):
    with pytest.raises(ValueError, match="rows_linear"):
        rows_gemm.plan(rows, k, 64)


def test_launch_bytes_count_weight_x_and_y_once():
    assert rows_gemm.launch_bytes(8, 1536, 6144) == 2 * (
        6144 * 1536 + 8 * 1536 + 8 * 6144)
    # a cat-gen token at gpt2_medium: 25.26M weights a layer (1.213 GB a
    # token over 24 layers) and 8 rows of x and y beside each
    per_layer = MODELS["gpt2_medium/tp1"].values()
    weights = sum(k * n for k, n in per_layer)
    assert 25.25e6 < weights < 25.27e6
    assert sum(rows_gemm.launch_bytes(8, k, n) for k, n in per_layer) == (
        2 * weights + 16 * sum(k + n for k, n in per_layer))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that `Dense.forward`
    routes it as it would a CUDA one (`rows_linear` still computes it on
    the CPU through the plain version)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def route(monkeypatch):
    """The calls of `rows_linear` that `Dense.forward` makes."""
    calls = []
    real = rows_gemm.rows_linear

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(rows_gemm, "rows_linear", spy)
    return calls


def _dense(k=96, n=40, dtype=torch.bfloat16):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return Dense(k, n, dtype)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_dense_takes_the_kernel_for_a_token_steps_input(route, rows):
    d = _dense()
    x = _x(rows, 96).reshape(rows, 1, 96).as_subclass(_OnCard)
    with torch.no_grad(), tgpt.cast_weights(d):
        got, w = d(x), d.cast
    x = x.as_subclass(torch.Tensor).reshape(rows, 96)
    assert route == [((rows, 1, 96), (40, 96))]
    assert got.shape == (rows, 1, 40) and got.dtype == torch.bfloat16
    assert within(got.reshape(rows, 40), F.linear(x, w), x, w)


@pytest.mark.parametrize("case", ["rows_616", "rows_17", "no_cast",
                                  "grad_on", "cpu", "cast_f32", "k_odd"])
def test_dense_keeps_f_linear_outside_the_kernels_domain(route, case):
    k = 92 if case == "k_odd" else 96
    dtype = torch.float32 if case == "cast_f32" else torch.bfloat16
    d = _dense(k, dtype=dtype)
    rows = {"rows_616": 616, "rows_17": 17}.get(case, 8)
    x = _x(rows, k)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "grad_on":        # training: no cast, gradients recorded
        d(x).sum().backward()
        assert d.weight.grad is not None
    elif case == "no_cast":
        with torch.no_grad():
            d(x)
    else:
        with torch.no_grad(), tgpt.cast_weights(d):
            d(x)
    assert route == []


def test_dense_with_cast_refuses_gradients():
    d = _dense()
    with tgpt.cast_weights(d), pytest.raises(RuntimeError, match="cast"):
        d(_x(8, 96).as_subclass(_OnCard))


def test_a_cpu_call_counts_no_launch():
    before = dict(rows_gemm.LAUNCHES), dict(rows_gemm.WORK)
    x, w = _x(8, 96), _weight(96, 40)
    got = rows_gemm.rows_linear(x.reshape(2, 4, 96), w)
    assert got.shape == (2, 4, 40)
    assert torch.equal(got.reshape(8, 40), rows_gemm.rows_linear_plain(x, w))
    assert (dict(rows_gemm.LAUNCHES), dict(rows_gemm.WORK)) == before


def test_a_cpu_sample_counts_no_launch():
    cfg = tcfg.GPTConfig(**SMALL)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval()
    te, tm, noise = _inputs(cfg)
    before = rows_gemm.LAUNCHES["rows_gemm"]
    gpt.sample(te, tm, gumbel_noise=noise)
    assert rows_gemm.LAUNCHES["rows_gemm"] == before


@pytest.mark.parametrize("shapes,match", [
    (((8, 96), (40, 90)), "shapes"),
    (((8, 96), (40, 96, 1)), "shapes")])
def test_the_wrapper_raises_on_shapes_it_does_not_take(shapes, match):
    (xs, ws) = shapes
    with pytest.raises(ValueError, match=match):
        rows_gemm.rows_linear(torch.zeros(xs, dtype=torch.bfloat16),
                              torch.zeros(ws, dtype=torch.bfloat16))


def test_launch_counts_and_work_counts_include_the_kernel():
    assert any(c is rows_gemm.LAUNCHES for c in graphs.launch_counts())
    assert graphs.work_counts()["rows_gemm"] is rows_gemm.WORK


SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
             dropout=0.0)


def _inputs(cfg, b=2, seed=1):
    rng = np.random.RandomState(seed)
    te = torch.from_numpy(rng.randn(b, cfg.max_text_len,
                                    cfg.n_cond_embed).astype(np.float32))
    tm = torch.from_numpy(rng.rand(b, cfg.max_text_len) > 0.3)
    tm[:, 0] = True
    seq = cfg.image_encoded_dim ** 2
    noise = torch.from_numpy(rng.gumbel(size=(seq, b, cfg.vocab_size))
                             .astype(np.float32))
    return te, tm, noise


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_rows_gemm.py -m card "
                    "--noconftest)")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("rows", (1, 2, 8, 9, 16))
@pytest.mark.parametrize("model", MODELS)
def test_kernel_is_the_plain_version_within_the_bound(card, model, rows):
    """One launch a call, y in bf16 of the plain version's shape, within
    `sum_bound` of it, the same bits twice."""
    for name, (k, n) in MODELS[model].items():
        w, x = _weight(k, n).to(card), _x(rows, k).to(card)
        with torch.inference_mode():
            before = rows_gemm.LAUNCHES["rows_gemm"]
            got = rows_gemm.rows_linear(x, w)
            assert rows_gemm.LAUNCHES["rows_gemm"] == before + 1
            again = rows_gemm.rows_linear(x, w)
        want = rows_gemm.rows_linear_plain(x, w)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert within(got, want, x, w), name
        assert torch.equal(got, again), name


@pytest.mark.card
@pytest.mark.parametrize("model", MODELS)
def test_plans_shared_memory_is_the_kernels(card, model):
    """`Plan.smem()`, which `plan` picks the ring's depth by, is the
    dynamic shared memory the kernel's library launches the plan with, for
    every product at every row count."""
    smem = _build.library("rows_gemm").favae_rows_gemm_smem
    smem.restype = ctypes.c_longlong
    sms = rows_gemm.sm_count(card)
    for name, (k, n) in MODELS[model].items():
        for rows in range(1, rows_gemm.MAX_ROWS + 1):
            p = rows_gemm.plan(rows, k, n, sms)
            assert p.smem() == smem(p.nb, p.kc, p.depth), (name, rows, p)


@pytest.mark.card
def test_sample_launches_counted_across_graph_replays(card):
    """GPT.sample in bf16 through `graphs.run_steps`: seven launches a
    layer a token (the eager first and each replay) and, the text context
    being 14 rows here (616 in cat-gen, where cuBLAS keeps it), one
    `project_kv` a layer; `rows_gemm.bytes` the bytes of those launches."""
    cfg = tcfg.GPTConfig(**SMALL)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpt = GPT(cfg, dtype=torch.bfloat16).eval().to(card)
    te, tm, noise = (t.to(card) for t in _inputs(cfg, b=1))
    before = rows_gemm.LAUNCHES["rows_gemm"], rows_gemm.WORK["bytes"]
    gpt.sample(te, tm, gumbel_noise=noise)
    seq, L = cfg.image_encoded_dim ** 2, cfg.n_layer
    rows, text = 2 * te.shape[0], 2 * te.numel() // cfg.n_cond_embed
    per_layer = sum(rows_gemm.launch_bytes(rows, k, n)
                    for k, n in _projections(cfg).values())
    context = rows_gemm.launch_bytes(text, cfg.n_cond_embed, cfg.dim_head)
    assert rows_gemm.LAUNCHES["rows_gemm"] - before[0] == (seq * 7 + 1) * L
    assert rows_gemm.WORK["bytes"] - before[1] == L * (seq * per_layer
                                                       + context)
