"""The serving token loop as one capturable step: the whole-step kernel's
position as a device scalar, `GPT.sample` and the fused route of
`sample_tokens`, on the CPU at tiny configs.

On the card `decode_step_fused` reads the position from a 0-dim tensor, as
the TPU kernel reads its SMEM `pos`, and `GPT.sample` and every route of
`sample_tokens` replay one CUDA graph of their token step
(`graphs.run_steps`). What makes that right is checked here: with a tensor
position the plain version (what the wrapper takes on the CPU) gives the
int call's bits and stays within one bf16 rounding of JAX's Pallas kernel
in interpret mode (tests/test_torch_port_int8_kernels.py's bound); the
attention modules give the int call's bits; the token steps make no host
sync (`NoHostSync` of tests/test_torch_port_decode_graph.py); and the
samplers still give the JAX package's tokens under its gumbel noise. The
graphs and the kernel's error word run only on the card (`chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import decode_engine as jengine
from favae_tpu.models import gpt as jgpt
from favae_tpu.ops import decode_step_kernel as jdk
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.models import decode_engine as tengine
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.ops import decode_step_kernel as dk
from tests.test_torch_port_decode_graph import NoHostSync, _inputs, _jax_noise
from tests.test_torch_port_int8_kernels import _assert_one_rounding, _bf16
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
             dropout=0.0)
# a width the whole-step kernel takes (tests/test_decode_step_kernel.py:26)
GATE = dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2, dim_head=64,
            n_cond_embed=32, image_encoded_dim=4, max_text_len=7,
            dropout=0.0)
INT8_LOGITS_ATOL = 0.1   # tests/test_torch_port_decode.py's bounds
AGREEMENT = 0.9


def _models(kw, dtype_j, dtype_t):
    cfg = jcfg.GPTConfig(**kw)
    model = jgpt.GPT(cfg, dtype=dtype_j)
    n = cfg.image_encoded_dim ** 2
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, n - 1), jnp.int32),
                        jnp.zeros((1, 7, 32), jnp.float32),
                        jnp.ones((1, 7), bool), cond_drop_prob=0.0)["params"]
    ours = tgpt.GPT(tcfg.GPTConfig(**kw), dtype=dtype_t).eval()
    ours.load_state_dict(gpt_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params)))
    return cfg, model, params, ours


@pytest.fixture(scope="module")
def small():
    return _models(SMALL, jnp.float32, torch.float32)


@pytest.fixture(scope="module")
def gate():
    cfg, model, params, ours = _models(GATE, jnp.bfloat16, torch.bfloat16)
    return cfg, params, ours, dk.prepare_fused_decode(ours, ours.cfg)


def _step_inputs(cfg, pos, seed):
    """Seeded inputs of one whole-step call, rows 8, S 16, M 8, the cache
    filled up to `pos` (as numpy f32, bf16-valued where the kernel takes
    bf16)."""
    rows, seq, m_cross = 8, 16, 8
    L, H, dh, d = cfg.n_layer, cfg.n_head, cfg.dim_head, cfg.n_embed
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, d).astype(np.float32)
    caches = rng.randn(L, rows, seq, dh).astype(np.float32)
    caches[:, :, pos:] = 0.0
    kv = rng.randn(L, rows, m_cross, dh).astype(np.float32)
    bias = np.where(rng.rand(rows, m_cross) > 0.3, 0.0, -1e9).astype(np.float32)
    bias[:, 0] = 0.0
    bias[rows // 2:, 1:] = -1e9        # the null-text half of a CFG batch
    rel = rng.randn(L, H, seq + 1).astype(np.float32)
    rel[..., 0] = 0.0
    return x, caches, kv, bias, rel


@pytest.mark.parametrize("pos", [0, 1, 7, 15])
def test_plain_step_with_a_device_position(gate, pos):
    """decode_step_fused on the CPU with a 0-dim int64 (and int32) tensor
    position: the int call's x and cache bits, within one bf16 rounding of
    JAX's kernel, and no host sync; cache rows past `pos` are not read."""
    cfg, params, ours, fused = gate
    x, caches, kv, bias, rel = _step_inputs(cfg, pos, 200 + pos)
    xj, xt = _bf16(x)
    cj, ct = _bf16(caches)
    kvj, kvt = _bf16(kv)
    args = (kvt, torch.from_numpy(bias), torch.from_numpy(rel), fused,
            ours.cfg)
    x_ref, c_ref = jdk.decode_step_fused(
        xj, jnp.asarray(pos, jnp.int32), cj, kvj, jnp.asarray(bias),
        jnp.asarray(rel), jdk.prepare_fused_decode(params, cfg), cfg,
        interpret=True)

    c_int = ct.clone()
    x_int, _ = dk.decode_step_fused(xt, pos, c_int, *args)
    for dtype in (torch.int64, torch.int32):
        c_dev = ct.clone()
        c_dev[:, :, pos + 1:] = 1e4                 # rows past pos: not read
        with NoHostSync():
            x_dev, out = dk.decode_step_fused(
                xt, torch.tensor(pos, dtype=dtype), c_dev, *args)
        assert out is c_dev, "the cache is written in place"
        assert torch.equal(x_dev, x_int)
        assert torch.equal(c_dev[:, :, : pos + 1], c_int[:, :, : pos + 1])
    _assert_one_rounding(x_dev, x_ref)
    _assert_one_rounding(c_dev[:, :, pos], c_ref[:, :, pos])


def test_position_outside_the_cache_raises_and_writes_nothing(gate):
    cfg, _, ours, fused = gate
    x, caches, kv, bias, rel = _step_inputs(cfg, 16, 5)
    ct = torch.from_numpy(caches).bfloat16()
    before = ct.clone()
    args = (torch.from_numpy(x).bfloat16(), None, ct,
            torch.from_numpy(kv).bfloat16(), torch.from_numpy(bias),
            torch.from_numpy(rel), fused, ours.cfg)
    for pos in (16, -1):
        with pytest.raises(ValueError, match="outside"):
            dk.decode_step_fused(*args[:1], pos, *args[2:])
    with pytest.raises(IndexError):
        dk.decode_step_fused(*args[:1], torch.tensor(16), *args[2:])
    assert torch.equal(ct, before)
    with pytest.raises(ValueError, match="0-dim"):
        dk.decode_step_fused(*args[:1], torch.tensor([3]), *args[2:])
    assert dk.position_errors("cpu") == 0     # the word lives on a card


def test_error_word_of_the_current_card(monkeypatch):
    """position_errors / check_positions find the word of cuda:0 when
    given "cuda" alone (the current card), read it once and clear it; a
    CPU tensor stands in for the card's word."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setitem(dk._ERRORS, 0, torch.tensor(2, dtype=torch.int32))
    assert dk.position_errors("cuda:1") == 0
    assert dk.position_errors("cuda") == 2
    assert dk.position_errors(torch.device("cuda:0")) == 0
    dk._ERRORS[0].fill_(1)
    with pytest.raises(RuntimeError, match="1 launch"):
        dk.check_positions("cuda")
    dk.check_positions("cuda:0")


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_attention_modules_with_a_device_position(small, pos):
    """MultiQueryAttention.decode_step (and the RelPosBias2d row it takes)
    with a 0-dim tensor position give the int call's bits, the cache row
    included, with no host sync."""
    _, _, _, ours = small
    attn = ours.blocks[0].self_attn
    rng = np.random.RandomState(pos)
    x_t = torch.from_numpy(rng.randn(4, 1, 64).astype(np.float32))
    cache = torch.from_numpy(rng.randn(4, 16, 16).astype(np.float32))
    at = torch.tensor(pos)
    bias_int = attn.rel_pos_bias(1, 17, row_offset=pos)
    with NoHostSync():
        bias_dev = attn.rel_pos_bias(1, 17, row_offset=at)
    assert bias_dev.shape == (4, 1, 17) and torch.equal(bias_dev, bias_int)
    c_int, c_dev = cache.clone(), cache.clone()
    with torch.inference_mode():
        out_int = attn.decode_step(x_t, c_int, pos)
        with NoHostSync():
            out_dev = attn.decode_step(x_t, c_dev, at)
    assert torch.equal(out_dev, out_int) and torch.equal(c_dev, c_int)
    assert not torch.equal(c_dev[:, pos], cache[:, pos])


@pytest.mark.parametrize("route", ["gpt_sample", "fused"])
def test_token_steps_make_no_host_sync(small, gate, route):
    """GPT.sample (with a generator, and with injected noise) and the
    fused route: every token queued, `on_token` 0..S-1 in order, and no
    value brought to the host."""
    te, tm = map(torch.from_numpy, _inputs(4))
    noise = _jax_noise(jax.random.PRNGKey(3), 16, 4, 64)
    for kw in (dict(generator=torch.Generator().manual_seed(5), top_k=8,
                    top_p=0.9),
               dict(gumbel_noise=noise, cond_scale=1.0)):
        seen = []
        with NoHostSync():
            if route == "gpt_sample":
                grid = small[3].sample(te, tm, on_token=seen.append, **kw)
            else:
                _, _, ours, fused = gate
                grid = tengine.sample_tokens(
                    ours.cfg, ours, te, tm, fused=fused,
                    on_token=seen.append, **kw)
        assert grid.shape == (4, 4, 4) and seen == list(range(16))
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(grid.sum())


@pytest.mark.parametrize("top_k,top_p,cond_scale", [(None, 1.0, 3.0),
                                                    (8, 0.9, 1.0)])
def test_gpt_sample_matches_jax_and_the_engine(small, top_k, top_p,
                                               cond_scale):
    """f32, B 2: GPT.sample under JAX's gumbel noise gives JAX's GPT.sample
    tokens and the exact `sample_tokens` tokens, token for token."""
    cfg, model, params, ours = small
    embeds, mask = _inputs(2)
    key = jax.random.PRNGKey(17)
    kw = dict(temperature=1.0, top_k=top_k, top_p=top_p, cond_scale=cond_scale)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(embeds),
                                 jnp.asarray(mask), rng=key,
                                 method=jgpt.GPT.sample, **kw))
    noise = _jax_noise(key, 16, 2, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    seen = []
    sampled = ours.sample(te, tm, gumbel_noise=noise, on_token=seen.append,
                          **kw)
    engine = tengine.sample_tokens(ours.cfg, ours, te, tm, gumbel_noise=noise,
                                   **kw)
    assert sampled.shape == (2, 4, 4) and sampled.dtype == torch.int64
    assert seen == list(range(16))
    np.testing.assert_array_equal(sampled.numpy(), ref)
    assert torch.equal(engine, sampled)


@pytest.fixture(scope="module")
def folded():
    """The small f32 GPT with `fold_ln_scale`, every LayerNorm's gamma drawn
    away from its init of ones (a gamma of ones folds to nothing)."""
    kw = dict(SMALL, fold_ln_scale=True)
    cfg, model, params, _ = _models(kw, jnp.float32, torch.float32)
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.3 * rng.randn(*v.shape).astype(np.float32)
                         if path[-1].key == "scale" else v), params)
    ours = tgpt.GPT(tcfg.GPTConfig(**kw), dtype=torch.float32).eval()
    ours.load_state_dict(gpt_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params)))
    return cfg, model, params, ours


@pytest.mark.parametrize("top_k,top_p,cond_scale", [(None, 1.0, 3.0),
                                                    (8, 0.9, 1.0)])
def test_gpt_sample_with_fold_ln_scale_matches_jax(folded, top_k, top_p,
                                                   cond_scale):
    """f32, B 2, a GPT built with `fold_ln_scale` in both packages:
    GPT.sample under JAX's gumbel noise gives JAX's GPT.sample tokens, token
    for token. The step applies the attention norms' gammas and folds the
    feed-forward's into fc1's and fc2's casts, as JAX's decode does."""
    cfg, model, params, ours = folded
    assert cfg.fold_ln_scale and ours.cfg.fold_ln_scale
    embeds, mask = _inputs(2, seed=3)
    key = jax.random.PRNGKey(29)
    kw = dict(temperature=1.0, top_k=top_k, top_p=top_p, cond_scale=cond_scale)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(embeds),
                                 jnp.asarray(mask), rng=key,
                                 method=jgpt.GPT.sample, **kw))
    noise = _jax_noise(key, 16, 2, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    sampled = ours.sample(te, tm, gumbel_noise=noise, **kw)
    assert sampled.shape == (2, 4, 4) and sampled.dtype == torch.int64
    np.testing.assert_array_equal(sampled.numpy(), ref)
    assert all(blk.ff[1].cast is None for blk in ours.blocks)


def test_fused_route_matches_the_jax_fused_engine(gate):
    """bf16, B 4 (8 CFG rows): the fused route on the plain version, its
    position a device tensor, against JAX's fused engine (Pallas in
    interpret mode): CFG logits under JAX's tokens as forced context within
    INT8_LOGITS_ATOL, free tokens agreeing at AGREEMENT."""
    cfg, params, ours, fused = gate
    embeds, mask = _inputs(4, seed=8)
    key = jax.random.PRNGKey(23)
    kw = dict(top_k=None, top_p=1.0, cond_scale=3.0)
    jkw = {"fused": jdk.prepare_fused_decode(params, cfg)}
    je, jm = jnp.asarray(embeds), jnp.asarray(mask)
    ref_free = np.asarray(jengine.sample_tokens(cfg, params, je, jm, rng=key,
                                                **kw, **jkw))
    _, ref_logits = jengine.sample_tokens(
        cfg, params, je, jm, rng=key,
        forced_tokens=jnp.asarray(ref_free.reshape(4, -1)),
        return_logits=True, **kw, **jkw)
    noise = _jax_noise(key, 16, 4, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    tkw = dict(fused=fused, gumbel_noise=noise, **kw)
    free = tengine.sample_tokens(ours.cfg, ours, te, tm, **tkw)
    _, logits = tengine.sample_tokens(
        ours.cfg, ours, te, tm, return_logits=True,
        forced_tokens=torch.from_numpy(ref_free.reshape(4, -1).copy()), **tkw)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=INT8_LOGITS_ATOL, rtol=0)
    agree = float((free.numpy() == ref_free).mean())
    assert agree >= AGREEMENT, f"token agreement {agree}"
