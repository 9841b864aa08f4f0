"""The attention chain of the exact token step in one launch an attention
sublayer (`favae_tpu_torch/ops/mqa_decode.py`, used by `models/gpt.py`'s
`MultiQueryAttention.decode_step` and `cross_step`).

On the CPU `self_attend` and `cross_attend` take their plain op sequences,
which must be what the token step ran before the kernel, bit for bit: each
form against the chain as `decode_step` and `cross_step` wrote it
(`MultiQueryAttention._attend` after the q scale, the cache's
`index_copy_`, the mask and `RelPosBias2d`'s row at the position), at
several positions, 16 and 24 heads and a tp slice of heads, with a padded
text mask; the cache's rows beyond the position change nothing and only the
row at it is written; `GPT.sample` gives the logits and tokens of the token
loop written out that way. The routing: `GPT.sample` calls each form once a
layer a token and never launches on the CPU; `GPT.forward` never calls
them. The `card` cases hold the kernel to its plain version within a
rounding of the output's largest magnitude in bf16 (in f32, a bound of
the sums' order and the approximate exp2), and count its launches across a
CUDA-graph replay. This file imports no JAX (on the card: python -m pytest
tests/test_torch_port_mqa_decode.py -m card --noconftest).
"""

import numpy as np
import pytest
import torch

from favae_tpu_torch import config as tcfg
from favae_tpu_torch import graphs
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.models.gpt import MultiQueryAttention
from favae_tpu_torch.ops import mqa_decode
from favae_tpu_torch.parallel.mesh import Group


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/torch_threads.py gives other files
    (not imported: under --noconftest on the card `tests` is not a package
    the run can import)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# gpt2_medium's attention at a narrow model width: 8 CFG rows, dh 64, a
# 16 x 16 token grid (S 256), 77 text tokens; HEADS: gpt2_medium's 16,
# gpt2_mini's 24 (not a power of two), and rank 1's 8 of 16 under tp=2
ROWS, DH, GRID, TEXT, DIM = 8, 64, 16, 77, 96
S = GRID * GRID
HEADS = {"16": (16, None), "24": (24, None), "16/tp2": (16, Group(None, 1, 2))}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
             dropout=0.0)


def _attn(heads, tp, dtype, causal, seed=0):
    """A seeded MultiQueryAttention (its null kv and bias table drawn too),
    with `tp` set as `shard_gpt_` sets it (its to_q is left whole: a case
    takes this rank's heads of the full q)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        attn = MultiQueryAttention(
            DIM, heads, DH, causal=causal,
            rel_pos_size=GRID if causal else None,
            context_dim=None if causal else 32, dtype=dtype).eval()
    attn.tp = tp
    return attn


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _q(attn, rng):
    """q of a token (this rank's heads, unscaled) as to_q gives it, and the
    normalised input it came from."""
    x_n = _t(rng, ROWS, 1, DIM).to(attn.dtype)
    q = attn.to_q(x_n)
    if attn.tp is not None:
        n = attn.local_heads * DH
        q = q[..., attn.tp.rank * n:(attn.tp.rank + 1) * n].contiguous()
    return q, x_n


def _scaled(attn, q):
    """`decode_step`'s and `cross_step`'s q before the kernel (their `_q`)."""
    q = q * (attn.dim_head ** -0.5)
    return q.reshape(q.shape[0], 1, attn.local_heads, attn.dim_head)


def _self_before(attn, q, kv, cache, pos):
    """`decode_step`'s chain before the kernel, its projections given."""
    at = torch.as_tensor(pos)
    q = _scaled(attn, q)
    cache.index_copy_(1, at.view(1), kv.to(cache.dtype))
    mask = (torch.arange(cache.shape[1]) <= at).expand(cache.shape[0], -1)
    bias = attn.rel_pos_bias(1, cache.shape[1] + 1, row_offset=at,
                             tp=attn.tp)[None]
    return attn._attend(q, cache, context_mask=mask, rel_bias=bias)


def _self_case(attn, pos, seed):
    rng = np.random.RandomState(seed)
    q, x_n = _q(attn, rng)
    kv = attn.to_kv(x_n)
    cache = _t(rng, ROWS, S, DH).to(attn.dtype)
    cache[:, pos:] = 0          # as GPT.sample leaves the rows it has not
    return q, kv, cache         # reached


def _self_now(attn, q, kv, cache, pos):
    rpb = attn.rel_pos_bias
    return mqa_decode.self_attend(q, kv, cache, torch.as_tensor(pos),
                                  attn.null_kv, rpb.table(attn.tp),
                                  rpb.pos_indices)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("heads", HEADS.keys())
@pytest.mark.parametrize("pos", [0, 1, 137, S - 1])
def test_self_form_equals_the_chain_before_the_kernel(pos, heads, dtype):
    """The output and the written cache, dtype and bits, and nothing
    launched."""
    attn = _attn(*HEADS[heads], dtype, causal=True)
    q, kv, cache = _self_case(attn, pos, seed=pos)
    want_cache = cache.clone()
    before = dict(mqa_decode.LAUNCHES)
    with torch.inference_mode():
        want = _self_before(attn, q, kv, want_cache, pos)
        got = _self_now(attn, q, kv, cache, pos)
    assert mqa_decode.LAUNCHES == before
    assert got.shape == (ROWS, 1, attn.local_heads * DH)
    assert _same_bits(got, want), (got.float() - want.float()).abs().max()
    assert _same_bits(cache, want_cache)


def _text_mask(rng, kind):
    """A CFG batch's mask: text rows padded after a random length, and the
    null half all false (`GPT.sample`'s mask2)."""
    lengths = rng.randint(1, TEXT, ROWS // 2)
    if kind == "whole":
        lengths[:] = TEXT
    text = torch.from_numpy(np.arange(TEXT)[None] < lengths[:, None])
    return torch.cat([text, torch.zeros_like(text)], 0)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("heads", HEADS.keys())
@pytest.mark.parametrize("kind", ["padded", "whole"])
def test_cross_form_equals_the_chain_before_the_kernel(kind, heads, dtype):
    attn = _attn(*HEADS[heads], dtype, causal=False)
    rng = np.random.RandomState(7)
    q, _ = _q(attn, rng)
    kv = attn.project_kv(_t(rng, ROWS, TEXT, 32))
    mask = _text_mask(rng, kind)
    before = dict(mqa_decode.LAUNCHES)
    with torch.inference_mode():
        want = attn._attend(_scaled(attn, q), kv, context_mask=mask)
        got = mqa_decode.cross_attend(q, kv, mask, attn.null_kv)
    assert mqa_decode.LAUNCHES == before
    assert _same_bits(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("pos", [0, 137, S - 1])
def test_cache_rows_beyond_pos_change_nothing(pos):
    """Garbage (finite) in the rows beyond the position gives the bits of
    zeros there; the row at the position is the new kv, every other row is
    as it was."""
    attn = _attn(16, None, torch.bfloat16, causal=True)
    q, kv, zeros = _self_case(attn, pos, seed=11)
    garbage = zeros.clone()
    garbage[:, pos:] = _t(np.random.RandomState(12), ROWS, S - pos, DH,
                          scale=1e4).to(garbage.dtype)
    was = garbage.clone()
    with torch.inference_mode():
        want = _self_now(attn, q, kv, zeros, pos)
        got = _self_now(attn, q, kv, garbage, pos)
    assert _same_bits(got, want)
    assert torch.equal(garbage[:, pos], kv[:, 0])
    rest = torch.arange(S) != pos
    assert torch.equal(garbage[:, rest], was[:, rest])


def test_decode_step_and_cross_step_route_through_the_forms(monkeypatch):
    """The modules' token steps are to_q / to_kv, one form's call, to_out:
    their outputs equal to_out of the chain before the kernel."""
    sa = _attn(16, None, torch.bfloat16, causal=True)
    ca = _attn(16, None, torch.bfloat16, causal=False)
    rng = np.random.RandomState(3)
    x_n = _t(rng, ROWS, 1, DIM).to(torch.bfloat16)
    cache = torch.zeros(ROWS, S, DH, dtype=torch.bfloat16)
    want_cache = cache.clone()
    kv_text = ca.project_kv(_t(rng, ROWS, TEXT, 32))
    mask = _text_mask(rng, "padded")
    calls = _count_calls(monkeypatch)
    with torch.inference_mode():
        for pos in (0, 1, 2):
            want = sa.to_out[1](_self_before(sa, sa.to_q(x_n), sa.to_kv(x_n),
                                             want_cache, pos))
            got = sa.decode_step(x_n, cache, torch.tensor(pos))
            assert _same_bits(got, want) and _same_bits(cache, want_cache)
        want = ca.to_out[1](ca._attend(_scaled(ca, ca.to_q(x_n)), kv_text,
                                       context_mask=mask))
        assert _same_bits(ca.cross_step(x_n, kv_text, mask), want)
    assert calls == {"self_attend": 3, "cross_attend": 1}


def _count_calls(monkeypatch, names=("self_attend", "cross_attend")):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(mqa_decode, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mqa_decode, name, counted)
    return calls


def _gpt(dtype, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return tgpt.GPT(tcfg.GPTConfig(**SMALL), dtype=dtype).eval()


def _inputs(b, seed=1):
    rng = np.random.RandomState(seed)
    te = torch.from_numpy(rng.randn(b, 7, 32).astype(np.float32))
    tm = torch.from_numpy(rng.rand(b, 7) > 0.2)
    noise = torch.from_numpy(rng.gumbel(size=(16, b, 64)).astype(np.float32))
    return te, tm, noise


def _steps_before_the_kernel(monkeypatch):
    """Put `decode_step` and `cross_step` back as they ran the chain before
    the kernel (`_self_before`, `_attend`)."""
    def decode_step(self, x_n, kv_cache, pos):
        out = _self_before(self, self.to_q(x_n), self.to_kv(x_n), kv_cache,
                           pos)
        return self.to_out[1](out)

    def cross_step(self, x_n, kv, context_mask):
        out = self._attend(_scaled(self, self.to_q(x_n)), kv,
                           context_mask=context_mask)
        return self.to_out[1](out)
    monkeypatch.setattr(MultiQueryAttention, "decode_step", decode_step)
    monkeypatch.setattr(MultiQueryAttention, "cross_step", cross_step)


def _sample_logits(gpt, te, tm, noise, **kw):
    seen = []
    gpt._logits = lambda x: seen.append(tgpt.GPT._logits(gpt, x)) or seen[-1]
    grid = gpt.sample(te, tm, gumbel_noise=noise, **kw)
    del gpt._logits
    return grid, seen


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("top_k,top_p", [(None, 1.0), (8, 0.9)])
def test_gpt_sample_gives_the_logits_and_tokens_before_the_kernel(
        monkeypatch, dtype, top_k, top_p):
    """B 4 (8 CFG rows) on the CPU: GPT.sample's logits at every step and
    its tokens under the same gumbel noise equal the token loop's with the
    chain as it ran before the kernel, bit for bit; each form is called
    once a layer a token and the launcher is never reached."""
    gpt = _gpt(dtype)
    te, tm, noise = _inputs(4)
    kw = dict(top_k=top_k, top_p=top_p, cond_scale=3.0)
    calls = _count_calls(monkeypatch)

    def no_launch(*a, **k):
        raise AssertionError("the kernel launched on CPU tensors")
    monkeypatch.setattr(mqa_decode, "_launch", no_launch)
    got, got_logits = _sample_logits(gpt, te, tm, noise, **kw)
    seq, L = 16, SMALL["n_layer"]
    assert calls == {"self_attend": seq * L, "cross_attend": seq * L}
    with monkeypatch.context() as m:
        _steps_before_the_kernel(m)
        want, want_logits = _sample_logits(gpt, te, tm, noise, **kw)
    assert len(got_logits) == len(want_logits) == seq
    for g, w in zip(got_logits, want_logits):
        assert _same_bits(g, w)
    assert torch.equal(got, want)


def test_forward_never_calls_the_forms(monkeypatch):
    """The teacher-forced forward (CAT training, the reference's check)
    keeps `_attend`, with and without gradients."""
    gpt = _gpt(torch.float32)
    calls = _count_calls(monkeypatch, ("self_attend", "cross_attend",
                                       "self_attend_plain",
                                       "cross_attend_plain"))
    te, tm, _ = _inputs(2)
    ids = torch.randint(0, 64, (2, 15), generator=torch.Generator()
                        .manual_seed(3))
    gpt(ids, te, tm, cond_drop_prob=0.0).sum().backward()
    with torch.no_grad():
        gpt.forward_with_cond_scale(ids, te, tm)
    assert not any(calls.values())


def _meta_self(**changes):
    t = dict(q=torch.zeros(2, 1, 64, device="meta"),
             kv=torch.zeros(2, 1, 16, device="meta"),
             cache=torch.zeros(2, 8, 16, device="meta"),
             pos=torch.zeros((), dtype=torch.long, device="meta"),
             null_kv=torch.zeros(16, device="meta"),
             table=torch.zeros(9, 8, device="meta")[:, 4:],
             pos_indices=torch.zeros(8, 8, dtype=torch.long, device="meta"))
    t.update(changes)
    return t


@pytest.mark.parametrize("change,match", [
    (dict(q=torch.zeros(2, 1, 64, device="meta").requires_grad_()),
     "gradients"),
    (dict(table=torch.zeros(9, 4, device="meta").requires_grad_()),
     "gradients"),
    (dict(cache=torch.zeros(2, 16, 8, device="meta").transpose(1, 2)),
     "contiguous"),
    (dict(q=torch.zeros(2, 1, 128, device="meta")[..., ::2]),
     "contiguous"),
    (dict(table=torch.zeros(4, 9, device="meta").t()), "contiguous"),
    (dict(cache=torch.zeros(2, 8, 16, dtype=torch.float16, device="meta")),
     "against keys"),
    (dict(table=torch.zeros(9, 3, device="meta")), "heads"),
    ({}, "device")])
def test_the_wrapper_raises_on_what_it_does_not_take(change, match):
    """Checked before any launch (here on meta tensors, which reach the
    checks as CUDA tensors would): tensors that record gradients, inputs
    that are not contiguous (the bias table's rows may be strided, a tp
    slice's columns), mismatched dtypes or heads, a device other than the
    CPU or CUDA. No fallback."""
    with pytest.raises(ValueError, match=match):
        mqa_decode.self_attend(**_meta_self(**change))


def test_the_cross_wrapper_raises_on_what_it_does_not_take():
    q, kv = torch.zeros(2, 1, 64, device="meta"), torch.zeros(
        2, 7, 16, device="meta")
    null, mask = torch.zeros(16, device="meta"), torch.ones(
        2, 7, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="contiguous"):
        mqa_decode.cross_attend(q, kv, torch.ones(7, 2, dtype=torch.bool,
                                                  device="meta").t(), null)
    with pytest.raises(ValueError, match="mask"):
        mqa_decode.cross_attend(q, kv, mask[:, :5].contiguous(), null)
    with pytest.raises(ValueError, match="device"):
        mqa_decode.cross_attend(q, kv, mask, null)


def test_launch_counts_include_the_kernel():
    assert any(c is mqa_decode.LAUNCHES for c in graphs.launch_counts())


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_mqa_decode.py -m card "
                    "--noconftest)")
    return torch.device("cuda:0")


def error_ratio(got, want, q, keys, null_kv):
    """max |got - want| over what the kernel may differ by; at most 1 is
    within it. bf16: one rounding of the output's largest magnitude (both
    sides round the scores, P and the output at the same points; where
    their f32 sums, run in another order, round the other way, the output
    moves by less). f32: nothing is rounded between, so the output, a
    convex combination of the K/V rows (the null's among them), moves by
    the sums' order and `tl.exp`'s approximate exp2, at most eps max|V|
    (n + 2 dh max_j sum_i |q_i k_ji| + 16) over n keys: the P V sum (n
    eps), each score's sum of dh products (moving its P entry relatively
    by twice its error), exp2's argument and result (under 16 eps over
    P)."""
    eps = torch.finfo(want.dtype).eps
    err = (got.float() - want.float()).abs().max()
    if want.dtype != torch.float32:
        return (err / (eps * want.float().abs().max())).item()
    b, dh = keys.shape[0], keys.shape[-1]
    v = torch.cat([null_kv.to(keys.dtype).expand(b, 1, dh), keys], 1).abs()
    qs = (q * dh ** -0.5).reshape(b, -1, dh).abs()
    spread = torch.einsum("bhd,bnd->bhn", qs, v).max()
    return (err / (eps * v.max() * (v.shape[1] + 2 * dh * spread + 16))
            ).item()


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("heads", ["16", "24"])
@pytest.mark.parametrize("pos", [0, 128, S - 1])
def test_kernel_within_a_rounding_of_the_plain_version(card, pos, heads,
                                                       dtype):
    """Both forms, one launch a call, the plain version's dtype and shape,
    within what the kernel may differ by (`error_ratio`); the cache written
    as the plain version writes it."""
    attn = _attn(*HEADS[heads], dtype, causal=True)
    cross = _attn(*HEADS[heads], dtype, causal=False)
    rng = np.random.RandomState(pos)
    with torch.inference_mode():
        case = (*_self_case(attn, pos, seed=pos),
                cross.project_kv(_t(rng, ROWS, TEXT, 32)),
                _text_mask(rng, "padded"))
    q, kv, cache, kv_text, mask = (t.to(card) for t in case)
    attn.to(card)
    cross.to(card)
    rpb = attn.rel_pos_bias
    at = torch.tensor(pos, device=card)
    with torch.inference_mode():
        plain_cache = cache.clone()
        want = mqa_decode.self_attend_plain(q, kv, plain_cache, at,
                                            attn.null_kv, rpb.table(),
                                            rpb.pos_indices)
        want_x = mqa_decode.cross_attend_plain(q, kv_text, mask,
                                               cross.null_kv)
        before = mqa_decode.LAUNCHES["mqa_decode"]
        got = _self_now(attn, q, kv, cache, at)
        got_x = mqa_decode.cross_attend(q, kv_text, mask, cross.null_kv)
        assert mqa_decode.LAUNCHES["mqa_decode"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(cache, plain_cache)
    ratios = [error_ratio(got, want, q, plain_cache, attn.null_kv),
              error_ratio(got_x, want_x, q, kv_text, cross.null_kv)]
    for g, w in ((got, want), (got_x, want_x)):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert max(ratios) <= 1, ratios
    with pytest.raises(ValueError, match="gradients"):
        mqa_decode.cross_attend(q.float().requires_grad_(), kv_text.float(),
                                mask, cross.null_kv)


@pytest.mark.card
def test_sample_launches_counted_across_graph_replays(card):
    """GPT.sample through `graphs.run_steps` on the card: 2 L launches a
    token, every token counted (the eager first and each replay), the same
    tokens as the plain version under the same noise at f32."""
    gpt = _gpt(torch.float32)
    te, tm, noise = _inputs(4)
    kw = dict(top_k=None, top_p=1.0, cond_scale=3.0)
    want = gpt.sample(te, tm, gumbel_noise=noise, **kw)
    gpt.to(card)
    before = mqa_decode.LAUNCHES["mqa_decode"]
    replays = graphs.STATS["replays"]
    got = gpt.sample(te.to(card), tm.to(card), gumbel_noise=noise, **kw)
    seq, L = 16, SMALL["n_layer"]
    assert graphs.STATS["replays"] - replays == seq - 1
    assert mqa_decode.LAUNCHES["mqa_decode"] - before == seq * 2 * L
    assert torch.equal(got.cpu(), want)
