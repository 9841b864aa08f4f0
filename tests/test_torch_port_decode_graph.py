"""The capturable token step of `sample_tokens` (exact and FFN-only
routes), on the CPU at tiny configs.

On the card the step is captured once in a CUDA graph and replayed for every
position (`favae_tpu_torch.graphs.run_steps`); on the CPU the same step runs
eagerly. What makes one capture right for all positions is checked here: the
step keeps the position as a 0-dim tensor and makes no host sync (run under
a dispatch mode that fails on `aten._local_scalar_dense` and `aten.nonzero`,
the two ways a tensor's value reaches the host), it still gives the JAX
engine's tokens and logits with `gumbel_noise`, `forced_tokens` and
`return_logits`, and it draws from the caller's generator. The graph itself
runs only on the card (`chip_smoke.py`'s serve slice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from favae_tpu import config as jcfg
from favae_tpu.models import decode_engine as jengine
from favae_tpu.models import gpt as jgpt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch import graphs
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.models import decode_engine as tengine
from favae_tpu_torch.models import gpt as tgpt
from favae_tpu_torch.ops import ffn_int8

# the exact route in f32; the FFN-only route in bf16 at a width the int8
# FFN block takes (tests/test_torch_port_decode.py's configs)
CONFIGS = {
    "exact": (dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4,
                   dim_head=16, n_cond_embed=32, image_encoded_dim=4,
                   max_text_len=7, dropout=0.0), jnp.float32, torch.float32),
    "qparams": (dict(vocab_size=64, n_layer=2, n_embed=128, n_head=2,
                     dim_head=64, n_cond_embed=32, image_encoded_dim=4,
                     max_text_len=7, dropout=0.0), jnp.bfloat16,
                torch.bfloat16),
}
INT8_LOGITS_ATOL = 0.1   # tests/test_torch_port_decode.py's bounds
AGREEMENT = 0.9


@pytest.fixture(scope="module", params=list(CONFIGS))
def route(request):
    kw, dtype_j, dtype_t = CONFIGS[request.param]
    cfg = jcfg.GPTConfig(**kw)
    model = jgpt.GPT(cfg, dtype=dtype_j)
    n = cfg.image_encoded_dim ** 2
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, n - 1), jnp.int32),
                        jnp.zeros((1, 7, 32), jnp.float32),
                        jnp.ones((1, 7), bool), cond_drop_prob=0.0)["params"]
    ours = tgpt.GPT(tcfg.GPTConfig(**kw), dtype=dtype_t).eval()
    ours.load_state_dict(gpt_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params)))
    if request.param == "qparams":
        jkw = {"qparams": jengine.quantize_decode_params(params)}
        tkw = {"qparams": tengine.quantize_decode_params(ours)}
    else:
        jkw, tkw = {"dtype": jnp.float32}, {}
    return request.param, cfg, params, ours, jkw, tkw


def _inputs(b, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(b, 7, 32).astype(np.float32), rng.rand(b, 7) > 0.2


def _jax_noise(key, seq_len, b, vocab):
    out = []
    for _ in range(seq_len):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (b, vocab),
                                              dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out))


class NoHostSync(TorchDispatchMode):
    """Fails on every operator that brings a tensor's value to the host."""

    SYNCS = ("aten::_local_scalar_dense", "aten::nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.SYNCS:
            raise AssertionError(f"host sync in the token step: {func}")
        return func(*args, **(kwargs or {}))


def test_capturable_step_matches_the_jax_engine(route):
    """B 4 (8 CFG rows), top-k 8, top-p 0.9: free tokens with injected noise,
    and logits under the JAX engine's tokens as forced context."""
    name, cfg, params, ours, jkw, tkw = route
    embeds, mask = _inputs(4)
    key = jax.random.PRNGKey(7)
    kw = dict(top_k=8, top_p=0.9, cond_scale=3.0)
    je, jm = jnp.asarray(embeds), jnp.asarray(mask)
    ref_free = np.asarray(jengine.sample_tokens(cfg, params, je, jm, rng=key,
                                                **kw, **jkw))
    _, ref_logits = jengine.sample_tokens(
        cfg, params, je, jm, rng=key,
        forced_tokens=jnp.asarray(ref_free.reshape(4, -1)),
        return_logits=True, **kw, **jkw)
    noise = _jax_noise(key, 16, 4, 64)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    free = tengine.sample_tokens(ours.cfg, ours, te, tm, gumbel_noise=noise,
                                 **kw, **tkw)
    forced, logits = tengine.sample_tokens(
        ours.cfg, ours, te, tm, gumbel_noise=noise, return_logits=True,
        forced_tokens=torch.from_numpy(ref_free.reshape(4, -1).copy()), **kw,
        **tkw)
    assert free.shape == (4, 4, 4) and logits.shape == (4, 16, 64)
    if name == "exact":
        np.testing.assert_array_equal(free.numpy(), ref_free)
        np.testing.assert_array_equal(forced.numpy(), ref_free)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-4, rtol=0)
        assert torch.equal(free, ours.sample(te, tm, gumbel_noise=noise, **kw))
    else:
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=INT8_LOGITS_ATOL, rtol=0)
        assert float((free.numpy() == ref_free).mean()) >= AGREEMENT


@pytest.mark.parametrize("hooks", ["generator", "noise_forced_logits"])
def test_token_loop_makes_no_host_sync(route, hooks):
    _, _, _, ours, _, tkw = route
    te, tm = map(torch.from_numpy, _inputs(1))
    if hooks == "generator":
        kw = dict(generator=torch.Generator().manual_seed(5), top_k=8,
                  top_p=0.9)
    else:
        kw = dict(gumbel_noise=_jax_noise(jax.random.PRNGKey(3), 16, 1, 64),
                  forced_tokens=torch.arange(16).reshape(1, 16) * 3 % 64,
                  return_logits=True)
    seen = []
    with NoHostSync():
        out = tengine.sample_tokens(ours.cfg, ours, te, tm,
                                    on_token=seen.append, **kw, **tkw)
    grid = out[0] if isinstance(out, tuple) else out
    assert grid.shape == (1, 4, 4) and seen == list(range(16))
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(grid.sum())


def test_step_draws_from_the_callers_generator(route):
    _, _, _, ours, _, tkw = route
    te, tm = map(torch.from_numpy, _inputs(1))

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        before = gen.get_state().clone()
        grid = tengine.sample_tokens(ours.cfg, ours, te, tm, generator=gen,
                                     **tkw)
        assert not torch.equal(gen.get_state(), before)   # drawn from it
        return grid

    a, b, c = sample(3), sample(3), sample(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_run_steps_runs_every_step_and_keeps_launch_counts_per_replay():
    calls, after = [], []
    graphs.run_steps(lambda: calls.append(len(calls)), 5, "cpu",
                     after=after.append)
    assert calls == list(range(5)) and after == list(range(5))
    counts = ffn_int8.LAUNCHES
    start = counts["ffn_int8"]

    def capture():          # the wrappers count while a graph captures
        counts["ffn_int8"] += 36

    taken = graphs.counts_of(capture)
    assert counts["ffn_int8"] == start                 # a capture launches nothing
    for _ in range(3):
        graphs.add_counts(taken)                       # a replay launches 36
    assert counts["ffn_int8"] == start + 3 * 36
    counts["ffn_int8"] = start
    assert all(sum(t.values()) == 0 for t in taken[:2] + taken[3:])
