"""favae_tpu_torch's samplers (`GPT.sample`, `sample_tokens` with its exact,
`qparams` and `fused` routes) against the JAX package's, on the CPU.

The two frameworks draw different noise from one seed, so each test computes
JAX's own gumbel noise (the `key, sub = split(key)` chain of
favae_tpu/models/gpt.py:587 and decode_engine.py:237) and injects the same
arrays into the port.

The exact route is compared in f32 and must give JAX's tokens exactly (the
logits differ by ~1e-5 and a flip would need a gumbel near-tie of that size).
The int8 routes are compared in bf16, where both sides round at the same
places (JAX through its Pallas kernels in interpret mode, the port through
the kernels' plain versions) but XLA and PyTorch sum in different orders, so
roundings flip: CFG logits under the same forced context must agree to 0.1
on logits of up to 2 (observed 0.024 on the FFN-only route, 0.008 on the
fused one), and free-running tokens at 0.9, the bound
tests/test_decode_step_kernel.py:60 uses (observed 1.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import decode_engine as jengine
from favae_tpu.models import gpt as jgpt
from favae_tpu.ops.decode_step_kernel import prepare_fused_decode as jax_fused
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.models import decode_engine as tengine
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.ops.decode_step_kernel import prepare_fused_decode
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7, dropout=0.0)
GATE = dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2, dim_head=64,
            n_cond_embed=32, image_encoded_dim=4, max_text_len=7, dropout=0.0)
INT8_LOGITS_ATOL = 0.1
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
    return _models(GATE, jnp.bfloat16, torch.bfloat16)


def _inputs(b, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(b, 7, 32).astype(np.float32), rng.rand(b, 7) > 0.2


def jax_gumbel_noise(key, seq_len, b, vocab):
    """The (S, b, vocab) noise GPT.sample / sample_tokens draw from `key`."""
    out = []
    for _ in range(seq_len):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (b, vocab),
                                              dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("top_k,top_p,cond_scale", [(None, 1.0, 3.0),
                                                    (8, 0.9, 1.0)])
def test_exact_samplers_match_jax_token_for_token(small, top_k, top_p,
                                                  cond_scale):
    cfg, model, params, ours = small
    embeds, mask = _inputs(2)
    key = jax.random.PRNGKey(42)
    kw = dict(temperature=1.0, top_k=top_k, top_p=top_p, cond_scale=cond_scale)
    ref = model.apply({"params": params}, jnp.asarray(embeds),
                      jnp.asarray(mask), rng=key, method=jgpt.GPT.sample, **kw)
    ref_engine = jengine.sample_tokens(cfg, params, jnp.asarray(embeds),
                                       jnp.asarray(mask), rng=key,
                                       dtype=jnp.float32, **kw)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ref_engine))

    noise = jax_gumbel_noise(key, 16, 2, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    sampled = ours.sample(te, tm, gumbel_noise=noise, **kw)
    engine = tengine.sample_tokens(ours.cfg, ours, te, tm, gumbel_noise=noise,
                                   **kw)
    assert sampled.shape == (2, 4, 4) and sampled.dtype == torch.int64
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(ref))
    assert torch.equal(engine, sampled)


def test_sample_tokens_audit_hooks(small):
    """Teacher-forcing the engine with its own grid reproduces its logits and
    its free samples; the logits trace is (b, S, vocab); the plain call is
    unchanged by the plumbing (tests/test_decode_engine.py:75)."""
    _, _, _, ours = small
    embeds, mask = map(torch.from_numpy, _inputs(2))
    noise = jax_gumbel_noise(jax.random.PRNGKey(11), 16, 2, 64)
    kw = dict(top_k=8, top_p=0.9, cond_scale=3.0, gumbel_noise=noise)
    grid, logits = tengine.sample_tokens(ours.cfg, ours, embeds, mask,
                                         return_logits=True, **kw)
    assert logits.shape == (2, 16, 64)
    grid2, logits2 = tengine.sample_tokens(
        ours.cfg, ours, embeds, mask, forced_tokens=grid.reshape(2, -1),
        return_logits=True, **kw)
    assert torch.equal(grid, grid2)
    torch.testing.assert_close(logits, logits2, atol=1e-5, rtol=0)
    assert torch.equal(grid, tengine.sample_tokens(ours.cfg, ours, embeds,
                                                   mask, **kw))
    # a forced context that differs changes the later logits
    other = (grid.reshape(2, -1) + 1) % 64
    _, logits3 = tengine.sample_tokens(ours.cfg, ours, embeds, mask,
                                       forced_tokens=other,
                                       return_logits=True, **kw)
    assert torch.equal(logits3[:, 0], logits[:, 0])
    assert not torch.allclose(logits3[:, 1:], logits[:, 1:], atol=1e-3)


def test_samplers_draw_from_the_generator_and_call_on_token(small):
    _, _, _, ours = small
    embeds, mask = map(torch.from_numpy, _inputs(1))
    seen = []
    a = ours.sample(embeds, mask, generator=torch.Generator().manual_seed(3),
                    top_k=8, on_token=seen.append)
    b = tengine.sample_tokens(ours.cfg, ours, embeds, mask, top_k=8,
                              generator=torch.Generator().manual_seed(3))
    c = ours.sample(embeds, mask, generator=torch.Generator().manual_seed(4),
                    top_k=8)
    assert seen == list(range(16))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < 64


def test_quantize_decode_params_equal_jax(gate):
    cfg, _, params, ours = gate
    ref = jengine.quantize_decode_params(params)["ffn"]
    qp = tengine.quantize_decode_params(ours)["ffn"]
    assert qp["w1q"].shape == (2, 128, 512) and qp["s1"].shape == (2, 1, 512)
    for k in ("w1q", "w2q"):
        np.testing.assert_array_equal(qp[k].numpy(), np.asarray(ref[k]))
    for k in ("s1", "s2", "c"):
        np.testing.assert_allclose(qp[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)
    back = qp["w1q"].float() * qp["s1"]
    w = torch.stack([blk.ff[1].weight.detach().T for blk in ours.blocks])
    torch.testing.assert_close(back, w, atol=2e-2, rtol=0)


@pytest.mark.parametrize("route", ["qparams", "fused"])
def test_int8_routes_match_jax(gate, route):
    """bf16 on both sides, B 4 (8 CFG rows), the gate config of
    tests/test_decode_step_kernel.py:26."""
    cfg, _, params, ours = gate
    embeds, mask = _inputs(4)
    key = jax.random.PRNGKey(42)
    kw = dict(top_k=None, top_p=1.0, cond_scale=3.0)
    if route == "fused":
        jkw = {"fused": jax_fused(params, cfg)}
        tkw = {"fused": prepare_fused_decode(ours, ours.cfg)}
    else:
        jkw = {"qparams": jengine.quantize_decode_params(params)}
        tkw = {"qparams": tengine.quantize_decode_params(ours)}
    je, jm = jnp.asarray(embeds), jnp.asarray(mask)
    ref_free = jengine.sample_tokens(cfg, params, je, jm, rng=key, **kw, **jkw)
    _, ref_logits = jengine.sample_tokens(
        cfg, params, je, jm, rng=key, forced_tokens=ref_free.reshape(4, -1),
        return_logits=True, **kw, **jkw)

    noise = jax_gumbel_noise(key, 16, 4, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    forced = torch.from_numpy(np.array(ref_free).reshape(4, -1))
    free = tengine.sample_tokens(ours.cfg, ours, te, tm, gumbel_noise=noise,
                                 **kw, **tkw)
    _, logits = tengine.sample_tokens(
        ours.cfg, ours, te, tm, gumbel_noise=noise, forced_tokens=forced,
        return_logits=True, **kw, **tkw)
    assert logits.shape == (4, 16, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=INT8_LOGITS_ATOL, rtol=0)
    agree = float((free.numpy() == np.asarray(ref_free)).mean())
    assert agree >= AGREEMENT, f"token agreement {agree}"

    # and against the port's own exact bf16 engine, as the JAX tests do
    exact = tengine.sample_tokens(ours.cfg, ours, te, tm, gumbel_noise=noise,
                                  **kw)
    agree = float((free == exact).float().mean())
    assert agree >= (AGREEMENT if route == "fused" else 0.5), agree
