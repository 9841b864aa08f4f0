"""The training forward of favae_tpu_torch's GPT against the JAX package's
(`GPT.__call__(train=True)`), on the CPU in f32 (JAX at "highest" matmul
precision), with JAX's weights carried across by `gpt_from_jax`.

Dropout masks do not cross packages, so the parity cases run at
dropout 0, with the conditioning-dropout keep mask JAX draws handed to the
port. Logits agree to atol 1e-4 (both sides in f32; they differ in
summation order and in LayerNorm's variance form, ~1e-6). The gradient of
the CE loss with respect to every parameter agrees per tensor to 1e-4 of
the tensor's largest entry. The port's own properties: every `remat`
policy gives the grads of "none" to 1e-6 relative with dropout 0.1 and one
generator seed (a recomputed block sees the masks of its first run), and
the weights get gradients outside `cast_weights`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import gpt as jgpt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7, dropout=0.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_gpt(fold=False):
    cfg = jcfg.GPTConfig(**SMALL, fold_ln_scale=fold)
    model = jgpt.GPT(cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 15), jnp.int32),
                        jnp.zeros((1, 7, 32), jnp.float32),
                        jnp.ones((1, 7), bool), cond_drop_prob=0.0)["params"]
    rng = np.random.RandomState(1)   # LayerNorm scales away from their init
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(1 + 0.2 * rng.randn(*a.shape), a.dtype)
                         if "scale" in jax.tree_util.keystr(path) else a),
        params)
    return model, params


def _port_gpt(params, **over):
    ours = tgpt.GPT(tcfg.GPTConfig(**{**SMALL, **over}), dtype=torch.float32)
    ours.load_state_dict(gpt_from_jax(_np_tree(params)), strict=True)
    return ours


@pytest.fixture(scope="module")
def gpts():
    return _jax_gpt()


def _inputs(b=3, n=15, seed=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 64, (b, n))
    embeds = rng.randn(b, 7, 32).astype(np.float32)
    mask = rng.rand(b, 7) > 0.3
    return ids, embeds, mask


def _jax_keep(key, b, p=0.25):
    """The conditioning keep mask the JAX GPT draws (gpt.py:515-519)."""
    return np.array(jax.random.uniform(jax.random.fold_in(key, 17), (b,))
                    < 1.0 - p)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("fold", [False, True])
def test_training_forward_matches_jax(fold):
    """train=True, the default cond_drop_prob 0.25 with JAX's keep mask
    injected; and with fold_ln_scale on both sides."""
    model, params = _jax_gpt(fold)
    ours = _port_gpt(params, fold_ln_scale=fold)
    ids, embeds, mask = _inputs()
    key = jax.random.PRNGKey(7)
    keep = _jax_keep(key, 3)
    assert keep.any() and not keep.all()    # both branches taken
    ref = model.apply({"params": params}, jnp.asarray(ids),
                      jnp.asarray(embeds), jnp.asarray(mask), train=True,
                      rng=key, rngs={"dropout": key})
    out = ours(*_t(ids, embeds, mask), train=True,
               cond_keep=torch.from_numpy(keep))
    assert out.shape == (3, 16, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)


def _ce(logits, z):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, z[..., None])[..., 0].mean()


@pytest.mark.parametrize("fold", [False, True])
def test_loss_grads_match_jax(fold):
    model, params = _jax_gpt(fold)
    ours = _port_gpt(params, fold_ln_scale=fold, remat="none")
    ids, embeds, mask = _inputs(n=16, seed=3)
    key = jax.random.PRNGKey(8)
    keep = _jax_keep(key, 3)

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(ids[:, :-1]),
                             jnp.asarray(embeds), jnp.asarray(mask),
                             train=True, rng=key, rngs={"dropout": key})
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(ids)[..., None], axis=-1))

    ref_loss, ref_grads = jax.value_and_grad(loss)(params)
    ref = gpt_from_jax(_np_tree(ref_grads))
    tids, temb, tmask = _t(ids, embeds, mask)
    out = _ce(ours(tids[:, :-1], temb, tmask, train=True,
                   cond_keep=torch.from_numpy(keep)), tids)
    out.backward()
    assert abs(out.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    grads = dict(ours.named_parameters())
    assert set(grads) == set(ref)
    for k, g in ref.items():
        ours_g = grads[k].grad
        scale = g.abs().max().item()
        assert scale > 0, k
        err = (ours_g - g).abs().max().item()
        assert err <= 1e-4 * scale, f"{k}: {err} vs max |g| {scale}"


def _grads(gpt, args, seed):
    gpt.zero_grad(set_to_none=True)
    g = torch.Generator().manual_seed(seed)
    ids = args[0]
    logits = gpt(ids[:, :-1], *args[1:], train=True, generator=g)
    _ce(logits, ids).backward()
    return {k: p.grad.clone() for k, p in gpt.named_parameters()}


@pytest.mark.parametrize("remat", ["full", "dots", "dots_nb"])
def test_remat_policies_give_the_grads_of_none(gpts, remat):
    _, params = gpts
    args = _t(*_inputs(n=16, seed=4))
    ref = _grads(_port_gpt(params, dropout=0.1, remat="none"), args, 11)
    got = _grads(_port_gpt(params, dropout=0.1, remat=remat), args, 11)
    for k, g in ref.items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (got[k] - g).abs().max().item() <= 1e-6 * scale, k


def test_dropout_draws_from_the_generator(gpts):
    """One seed gives one loss; another seed another; dropout on changes
    the logits; no generator raises rather than use the global RNG."""
    _, params = gpts
    ours = _port_gpt(params, dropout=0.1)
    args = _t(*_inputs(n=15, seed=5))

    def logits(seed):
        with torch.no_grad():
            return ours(*args, train=True, generator=torch.Generator()
                        .manual_seed(seed))

    a, b, c = logits(1), logits(1), logits(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        plain = ours(*args, cond_drop_prob=0.0)
        train0 = ours(*args, train=True, cond_drop_prob=0.0,
                      generator=torch.Generator().manual_seed(1))
    assert not torch.equal(plain, train0)
    with pytest.raises(ValueError, match="Generator"):
        ours(*args, train=True)
    with pytest.raises(ValueError, match="Generator"):
        ours(*args, cond_drop_prob=0.5)


def test_weights_get_grads_outside_cast_weights(gpts):
    """The training step never runs under `cast_weights` (the sampler's
    detached bf16 copies): every Dense weight gets a non-zero gradient, and
    a forward that records gradients raises while the copies are held."""
    _, params = gpts
    ours = _port_gpt(params)
    args = _t(*_inputs(n=16, seed=6))
    grads = _grads(ours, args, 3)
    dense = [n for n, m in ours.named_modules() if isinstance(m, tgpt.Dense)]
    assert len(dense) == 2 * 8   # q, kv, out twice; fc1, fc2
    for n in dense:
        assert grads[f"{n}.weight"].abs().max().item() > 0, n
    with ours.cast_weights():
        with pytest.raises(RuntimeError, match="cast_weights"):
            ours(args[0][:, :-1], *args[1:], cond_drop_prob=0.0)

