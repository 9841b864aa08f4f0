"""The LayerNorm chains of the exact token step fused into one launch a
sublayer boundary (`favae_tpu_torch/ops/ln_fused.py`, used by
`models/gpt.py`'s decode path).

On the CPU `add_ln` and `gelu_ln` take their plain op sequences, which must
be what the token step ran before the fusion, bit for bit: each form against
the unfused modules (`FixedBetaLayerNorm`, `nn.GELU`, the casts and the
residual add as `MultiQueryAttention._out`, `FeedForward.forward` and
`GPT.sample` wrote them), and `GPT.sample` against the token loop written
out that way (the same logits and tokens under fixed gumbel noise). The
routing: `GPT.sample` calls the ops a boundary at a time and never launches
on the CPU; `GPT.forward` never calls them; a spanning tp group keeps its
split statistics of the feed-forward's middle (two gloo ranks). The
`card` cases hold the kernel to its plain version within a rounding of the
stored dtype, and count its launches across a CUDA-graph replay. This file
imports no JAX (on the card: python -m pytest
tests/test_torch_port_ln_fused.py -m card --noconftest).
"""

import numpy as np
import pytest
import torch
from torch import nn

from favae_tpu_torch import config as tcfg
from favae_tpu_torch import graphs
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.models.gpt import FixedBetaLayerNorm
from favae_tpu_torch.ops import ln_fused


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/torch_threads.py gives other files
    (not imported: under --noconftest on the card `tests` is not a package
    the run can import)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
             dropout=0.0)
FORMS = ("boundary", "residual", "init", "final", "gelu")


def _norm(d, rng):
    ln = FixedBetaLayerNorm(d)
    with torch.no_grad():
        ln.gamma.copy_(torch.from_numpy(1 + 0.2 * rng.randn(d)))
    return ln


def _case(form, dtype, d, rows, seed=0):
    """Inputs of one form, as the token step gives them: h a projection's
    output in `dtype` (f32 rows of the embedding for `init`), x the
    residual stream in `dtype`, two seeded LayerNorms."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(3 * rng.randn(rows, 1, d).astype(np.float32))
    x = torch.from_numpy(rng.randn(rows, 1, d).astype(np.float32))
    return (h if form == "init" else h.to(dtype)), x.to(dtype), \
        _norm(d, rng), _norm(d, rng)


def _unfused(form, h, x, ln_a, ln_b, dtype):
    """The op sequence each form replaces, as the modules ran it."""
    if form == "boundary":    # MultiQueryAttention._out, + x, next norm
        x = ln_a(h).to(x.dtype) + x
        return x, ln_b(x).to(dtype)
    if form == "residual":    # FeedForward.forward's h.to(x.dtype), + x
        x = h.to(x.dtype) + x
        return x, ln_b(x).to(dtype)
    if form == "init":        # init_norm, then the first self-attention's
        x = ln_a(h).to(dtype)
        return x, ln_b(x).to(dtype)
    if form == "final":       # the last residual add, then final_norm (f32)
        x = h.to(x.dtype) + x
        return x, ln_b(x[:, 0, :])[:, None, :]
    return None, ln_b(nn.GELU()(h)).to(dtype)   # FeedForward's middle


def _fused(form, h, x, ln_a, ln_b, dtype):
    if form == "gelu":
        return None, ln_fused.gelu_ln(h, ln_b.gamma, dtype)
    return ln_fused.add_ln(
        h, None if form == "init" else x,
        ln_a.gamma if form in ("boundary", "init") else None, ln_b.gamma,
        torch.float32 if form == "final" else dtype)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("rows", [8, 2])
@pytest.mark.parametrize("d", [1536, 6144, 1001])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_forms_equal_the_unfused_op_sequence(form, dtype, d, rows):
    """Each form on CPU tensors gives the unfused sequence's outputs, dtype
    and bits, and launches nothing."""
    h, x, ln_a, ln_b = _case(form, dtype, d, rows, seed=d + rows)
    before = dict(ln_fused.LAUNCHES)
    with torch.inference_mode():
        got = _fused(form, h, x, ln_a, ln_b, dtype)
        want = _unfused(form, h, x, ln_a, ln_b, dtype)
    assert ln_fused.LAUNCHES == before
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _same_bits(g, w), (form, g.dtype, w.dtype,
                                      (g.float() - w.float()).abs().max())


def _gpt(dtype, seed=0):
    """A small GPT with seeded weights, its LayerNorms' gammas drawn too."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gpt = tgpt.GPT(tcfg.GPTConfig(**SMALL), dtype=dtype).eval()
        with torch.no_grad():
            for m in gpt.modules():
                if isinstance(m, FixedBetaLayerNorm):
                    m.gamma.add_(0.2 * torch.randn_like(m.gamma))
    return gpt


def _inputs(b, seed=1):
    rng = np.random.RandomState(seed)
    te = torch.from_numpy(rng.randn(b, 7, 32).astype(np.float32))
    tm = torch.from_numpy(rng.rand(b, 7) > 0.2)
    noise = torch.from_numpy(rng.gumbel(size=(16, b, 64)).astype(np.float32))
    return te, tm, noise


@torch.inference_mode()
def _sample_unfused(gpt, te, tm, noise, top_k, top_p, cond_scale):
    """GPT.sample's token loop as it ran before the fused boundaries:
    every LayerNorm its own op between casts, the residual adds apart, the
    feed-forward through `FeedForward.forward`. Returns (tokens, the CFG
    batch's logits of every step)."""
    c, b = gpt.cfg, te.shape[0]
    seq = c.image_encoded_dim ** 2
    ctx2 = torch.cat([te, te], 0).float()
    mask2 = torch.cat([tm, torch.zeros_like(tm)], 0)
    tokens, logits_all = torch.zeros((b, seq), dtype=torch.long), []
    with gpt.cast_weights():
        cross_kv = [blk.cross_attn.project_kv(ctx2) for blk in gpt.blocks]
        caches = torch.zeros((c.n_layer, 2 * b, seq, c.dim_head),
                             dtype=gpt.dtype)
        axial, prev = gpt._axial_pos(), None
        for pos in range(seq):
            x = (gpt.start_token.expand(2 * b, -1) if pos == 0
                 else gpt.tok_emb(prev) + axial[pos - 1])
            x = gpt.init_norm(x)[:, None, :].to(gpt.dtype)
            for l, (sa, ca, ff) in enumerate(gpt.blocks):
                h = sa.decode_step(sa.norm(x).to(sa.dtype), caches[l], pos)
                x = sa.to_out[2](h).to(x.dtype) + x
                h = ca.cross_step(ca.norm(x).to(ca.dtype), cross_kv[l], mask2)
                x = ca.to_out[2](h).to(x.dtype) + x
                x = ff(x) + x
            logits2 = gpt._logits(gpt.final_norm(x[:, 0, :]))
            logits_all.append(logits2)
            cond, null = logits2[:b], logits2[b:]
            logits = null + (cond - null) * cond_scale
            logits = tgpt.top_k_top_p_filter(logits, top_k, top_p)
            tok = tgpt.gumbel_sample(logits, noise=noise[pos])
            tokens[:, pos] = tok
            prev = torch.cat([tok, tok], 0)
    return tokens, logits_all


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("top_k,top_p", [(None, 1.0), (8, 0.9)])
def test_gpt_sample_gives_the_unfused_logits_and_tokens(dtype, top_k, top_p):
    """B 4 (8 CFG rows) on the CPU: GPT.sample's logits at every step equal
    the unfused loop's bit for bit, and so its tokens under the same gumbel
    noise."""
    gpt = _gpt(dtype)
    te, tm, noise = _inputs(4)
    kw = dict(top_k=top_k, top_p=top_p, cond_scale=3.0)
    want, want_logits = _sample_unfused(gpt, te, tm, noise, **kw)
    seen = []
    gpt._logits = lambda x: seen.append(tgpt.GPT._logits(gpt, x)) or seen[-1]
    grid = gpt.sample(te, tm, gumbel_noise=noise, **kw)
    assert len(seen) == len(want_logits) == 16
    for got, ref in zip(seen, want_logits):
        assert _same_bits(got, ref)
    assert torch.equal(grid.reshape(4, -1), want)


def _count_calls(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ln_fused, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ln_fused, name, counted)
    return calls


def test_sample_calls_a_boundary_at_a_time_and_launches_nothing_on_cpu(
        monkeypatch):
    """A token step: the embedding's boundary, three a layer and the
    feed-forward's middle; the launcher is never reached on CPU tensors."""
    gpt = _gpt(torch.bfloat16)
    te, tm, noise = _inputs(2)
    calls = _count_calls(monkeypatch, ("add_ln", "gelu_ln"))

    def no_launch(*a, **k):
        raise AssertionError("the kernel launched on CPU tensors")
    monkeypatch.setattr(ln_fused, "_launch", no_launch)
    gpt.sample(te, tm, gumbel_noise=noise, top_k=8)
    seq, L = 16, SMALL["n_layer"]
    assert calls == {"add_ln": seq * (1 + 3 * L), "gelu_ln": seq * L}


def test_forward_never_calls_the_fused_ops(monkeypatch):
    """The teacher-forced forward (CAT training, the reference's check)
    keeps its own LayerNorms, with and without gradients."""
    gpt = _gpt(torch.float32)
    calls = _count_calls(monkeypatch, ("add_ln", "gelu_ln", "add_ln_plain",
                                       "gelu_ln_plain"))
    te, tm, _ = _inputs(2)
    ids = torch.randint(0, 64, (2, 15), generator=torch.Generator()
                        .manual_seed(3))
    gpt(ids, te, tm, cond_drop_prob=0.0).sum().backward()
    with torch.no_grad():
        gpt.forward_with_cond_scale(ids, te, tm)
    assert not any(calls.values())


def test_a_spanning_tp_group_keeps_the_plain_sequence(tmp_path):
    """Two gloo ranks, tp=2, f32: GPT.sample runs every boundary through
    `add_ln` (its inputs summed over tp first), which on CPU tensors takes
    `add_ln_plain` and launches nothing, and the feed-forward's middle
    through the split statistics, never `gelu_ln`; both ranks sample the
    tokens of one process without a group."""
    from tests.torch_dist_worker import launch
    gpt = _gpt(torch.float32, seed=4)
    te, tm, noise = _inputs(2, seed=5)
    kw = dict(top_k=None, top_p=1.0, cond_scale=3.0)
    want = gpt.sample(te, tm, gumbel_noise=noise, **kw)
    ranks = launch("gpt_sample_tp", dict(
        cfg=gpt.cfg, tp=2, gpt={k: v.numpy() for k, v in
                                gpt.state_dict().items()},
        te=te, tm=tm, noise=noise, kw=kw), 2, tmp_path)
    seq, L = 16, SMALL["n_layer"]
    for r in ranks:
        assert r["calls"] == {"add_ln": seq * (1 + 3 * L), "gelu_ln": 0,
                              "add_ln_plain": seq * (1 + 3 * L),
                              "gelu_ln_plain": 0,
                              "split_layer_norm": seq * L}
        assert r["launches"] == 0
        assert torch.equal(r["tokens"], want)


def test_the_wrapper_raises_on_what_it_does_not_take():
    """A device other than the CPU or CUDA, and (checked before any launch)
    tensors that record gradients: no fallback."""
    h = torch.zeros(2, 1, 16, device="meta")
    g = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="device"):
        ln_fused.add_ln(h, h, g, g, torch.float32)
    with pytest.raises(ValueError, match="device"):
        ln_fused.gelu_ln(h, g, torch.float32)


def test_launch_counts_include_the_kernel():
    assert any(c is ln_fused.LAUNCHES for c in graphs.launch_counts())


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_ln_fused.py -m card --noconftest)")
    return torch.device("cuda:0")


def _within_a_rounding(got, want):
    """|got - want| within a rounding of the stored dtype: of the element,
    and of its row's largest for each of the (up to two) LayerNorms of the
    chain, whose f32 sums run in another order (and a residual element
    rounded the other way moves its row's statistics by that much)."""
    eps = torch.finfo(want.dtype).eps
    got, want = got.float(), want.float()
    row = want.abs().amax(-1, keepdim=True)
    return bool(((got - want).abs() <= eps * (want.abs() + 2 * row)).all())


@pytest.mark.card
@pytest.mark.parametrize("d", [1536, 6144, 1001])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", FORMS)
def test_kernel_within_a_rounding_of_the_plain_version(card, form, dtype, d):
    """One launch a call, dtypes and shapes of the plain version, values
    within a rounding of the stored dtype."""
    h, x, ln_a, ln_b = (t.to(card) for t in _case(form, dtype, d, 8,
                                                   seed=d))
    with torch.inference_mode():
        want = _unfused(form, h, x, ln_a, ln_b, dtype)
        before = ln_fused.LAUNCHES["add_ln"]
        got = _fused(form, h, x, ln_a, ln_b, dtype)
        assert ln_fused.LAUNCHES["add_ln"] == before + 1
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert _within_a_rounding(g, w), (form, (g.float() - w.float())
                                              .abs().max())
    with pytest.raises(ValueError, match="gradients"):
        ln_fused.add_ln(h.float().requires_grad_(), None, ln_a.gamma,
                        ln_b.gamma, dtype)


@pytest.mark.card
def test_sample_launches_counted_across_graph_replays(card):
    """GPT.sample through `graphs.run_steps` on the card: 1 + 4 L launches
    a token, every token counted (the eager first and each replay), the
    same tokens as the plain version under the same noise at f32."""
    gpt = _gpt(torch.float32)
    te, tm, noise = _inputs(4)
    kw = dict(top_k=None, top_p=1.0, cond_scale=3.0)
    want = gpt.sample(te, tm, gumbel_noise=noise, **kw)
    gpt.to(card)
    before = ln_fused.LAUNCHES["add_ln"]
    replays = graphs.STATS["replays"]
    got = gpt.sample(te.to(card), tm.to(card), gumbel_noise=noise, **kw)
    seq, L = 16, SMALL["n_layer"]
    assert graphs.STATS["replays"] - replays == seq - 1
    assert ln_fused.LAUNCHES["add_ln"] - before == seq * (1 + 4 * L)
    assert torch.equal(got.cpu(), want)
