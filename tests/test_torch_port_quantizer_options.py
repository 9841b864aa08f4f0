"""The quantizer's train options in the port against the JAX package's, on
the CPU: gumbel sampling, the orthogonal regulariser (all codes, active
codes only, a sample of max codes), k-means and dead-code expiry.

The port takes its random draws as arguments; here they are the JAX
package's own draws (the gumbel noise, the expiry candidates, the
max-codes permutation and k-means' first permutation, made by
`jax.random` from the keys the JAX functions use), converted through
numpy. Tolerances: indices and bins exactly; the orthogonal losses 1e-6
relative, their input gradients 1e-5 of the largest entry; k-means means
1e-5; the EMA state after expiry 1e-6 (the rows that expired are copies
of batch vectors and the expired set is exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import quantizer as jq
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.models import quantizer as tq
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _case(cosine, seed, n=96, k=32, d=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    embed = rng.randn(k, d).astype(np.float32) * 0.5
    if cosine:
        embed = _unit(embed).astype(np.float32)
    cluster = (rng.rand(k) * 2.0).astype(np.float32)
    avg = (embed * rng.rand(k, 1)).astype(np.float32)
    return x, embed, cluster, avg


def _states(embed, cluster, avg):
    return (jq.CodebookState(embed=jnp.asarray(embed),
                             cluster_size=jnp.asarray(cluster),
                             embed_avg=jnp.asarray(avg)),
            tq.CodebookState(embed=_t(embed), cluster_size=_t(cluster),
                             embed_avg=_t(avg)))


@pytest.mark.parametrize("cosine", [True, False])
def test_gumbel_indices_match_jax(cosine):
    """Temperature 0.7: argmax of the scores / temperature plus JAX's
    gumbel noise, eval and train lookups; the noise changes the codes."""
    x, embed, cluster, avg = _case(cosine, seed=1)
    kw = dict(codebook_size=32, dim=8, use_cosine_sim=cosine,
              sample_codebook_temp=0.7)
    js, ts = _states(embed, cluster, avg)
    key = jax.random.PRNGKey(3)
    noise = jax.random.gumbel(key, (x.shape[0], 32), jnp.float32)
    draws = tq.QuantizerDraws(gumbel=_t(noise))
    for train in (False, True):
        _, jidx, _ = jq.codebook_lookup(jcfg.QuantizerConfig(**kw), js,
                                        jnp.asarray(x), train=train, rng=key)
        _, tidx, _ = tq.codebook_lookup(tcfg.QuantizerConfig(**kw), ts,
                                        _t(x), train=train, draws=draws)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _, plain, _ = tq.codebook_lookup(
        tcfg.QuantizerConfig(**{**kw, "sample_codebook_temp": 0.0}), ts,
        _t(x))
    assert (plain != tidx).any()


@pytest.mark.parametrize("variant", ["all", "active", "max_codes"])
def test_orthogonal_losses_match_jax(variant):
    """The regulariser in VectorQuantize's train loss, taken over the new
    codes (all of them, those the batch used, or JAX's sample of 12),
    beside the commitment term; 1e-6 relative. Its gradient reaches the
    input through the EMA update, as in the JAX package: the input
    gradient within 1e-5 of JAX's largest entry."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 4, 8).astype(np.float32)
    _, embed, cluster, avg = _case(True, seed=5)
    kw = dict(codebook_size=32, dim=8, commitment_weight=0.25,
              orthogonal_reg_weight=10.0,
              orthogonal_reg_active_codes_only=variant == "active",
              orthogonal_reg_max_codes=12 if variant == "max_codes" else None)
    js, ts = _states(embed, cluster, avg)
    key = jax.random.PRNGKey(7)

    def jfn(x):
        _, _, loss, state = jq.VectorQuantize(
            jcfg.QuantizerConfig(**kw)).apply({}, x, js, train=True, rng=key)
        return loss, state

    (jloss, jstate), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(x))
    draws = tq.draw_quantizer(tcfg.QuantizerConfig(**kw), 32,
                              torch.Generator().manual_seed(0))
    if variant == "max_codes":
        assert draws.ortho_codes.shape == (12,)
        draws.ortho_codes = _t(jax.random.permutation(
            jax.random.fold_in(key, 2), 32)[:12]).long()
    else:
        assert draws.ortho_codes is None
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    _, _, tloss, tstate = tq.VectorQuantize(tcfg.QuantizerConfig(**kw))(
        xt, ts, train=True, draws=draws)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    # the regulariser alone, at the same codes, against the JAX function
    codes = np.asarray(jstate.embed)
    if variant == "all":
        ref, ours = jq.orthogonal_loss_fn(jnp.asarray(codes)), \
            tq.orthogonal_loss_fn(_t(codes))
    elif variant == "active":
        active = np.zeros(32, bool)
        active[:9] = True
        ref = jq.masked_orthogonal_loss_fn(jnp.asarray(codes),
                                           jnp.asarray(active))
        ours = tq.masked_orthogonal_loss_fn(_t(codes), _t(active))
    else:
        sel = np.asarray(draws.ortho_codes)
        ref = jq.orthogonal_loss_fn(jnp.asarray(codes[sel]))
        ours = tq.orthogonal_loss_fn(_t(codes)[draws.ortho_codes])
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tstate.embed.detach().numpy(), codes,
                               atol=1e-6)
    # the gradient at the input: the commitment term's, plus the
    # regulariser's through the EMA update of the new codes (the JAX
    # package differentiates through its functional EMA state)
    (grad,) = torch.autograd.grad(tloss, xt)
    scale = np.abs(np.asarray(jgrad)).max()
    np.testing.assert_allclose(grad.permute(0, 2, 3, 1).numpy() / scale,
                               np.asarray(jgrad) / scale, atol=1e-5)
    kw0 = dict(kw, orthogonal_reg_weight=0.0)
    xt0 = _t(x).permute(0, 3, 1, 2).requires_grad_()
    _, _, loss0, _ = tq.VectorQuantize(tcfg.QuantizerConfig(**kw0))(
        xt0, ts, train=True)
    (grad0,) = torch.autograd.grad(loss0, xt0)
    assert not torch.allclose(grad, grad0)
    assert float(tloss.detach()) > float(loss0.detach())


@pytest.mark.parametrize("cosine,n,k", [(True, 200, 16), (False, 200, 16),
                                        (True, 64, 64)])
def test_kmeans_matches_jax(cosine, n, k):
    """Means within 1e-5 and bins exactly, from JAX's first permutation
    (N = K included); the port's kmeans follows JAX's formulas on the
    CPU."""
    rng = np.random.RandomState(11)
    centres = rng.randn(k // 2, 8).astype(np.float32) * 3
    samples = (centres[rng.randint(0, k // 2, n)]
               + rng.randn(n, 8).astype(np.float32) * 0.3)
    if cosine:
        samples = _unit(samples).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jmeans, jbins = jq.kmeans(key, jnp.asarray(samples), k, num_iters=5,
                              use_cosine_sim=cosine)
    first = _t(jax.random.permutation(key, n)).long()
    means, bins = tq.kmeans(_t(samples), k, 5, cosine, first)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), atol=1e-5)
    assert bins.sum() == n


def test_kmeans_with_fewer_inputs_than_codes():
    """N < K: the JAX function stops at its update's broadcast (a
    TypeError); the port raises a ValueError that names N and K."""
    samples = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jq.kmeans(jax.random.PRNGKey(1), jnp.asarray(samples), 16, 2, True)
    with pytest.raises(ValueError, match="N = 8 < K = 16"):
        tq.kmeans(_t(samples), 16, 2, True, torch.randperm(8))


@pytest.mark.parametrize("cosine", [True, False])
def test_expiry_matches_jax(cosine):
    """Threshold 0.9 after the EMA update: the codes whose count fell
    below it take JAX's candidates (l2-normalised batch vectors), count =
    the threshold, embed_avg = candidate x threshold; equal sets of
    expired codes and `cb_replaced` (codes at exactly the threshold)."""
    x, embed, cluster, avg = _case(cosine, seed=3)
    kw = dict(codebook_size=32, dim=8, use_cosine_sim=cosine,
              threshold_ema_dead_code=0.9)
    js, ts = _states(embed, cluster, avg)
    key = jax.random.PRNGKey(9)
    _, jidx, jnew = jq.codebook_lookup(jcfg.QuantizerConfig(**kw), js,
                                       jnp.asarray(x), train=True, rng=key)
    cand = jax.random.randint(jax.random.fold_in(key, 1), (32,), 0,
                              x.shape[0])
    draws = tq.draw_quantizer(tcfg.QuantizerConfig(**kw), x.shape[0],
                              torch.Generator().manual_seed(0))
    assert draws.candidates.shape == (32,) and draws.gumbel is None
    draws.candidates = _t(cand).long()
    _, tidx, tnew = tq.codebook_lookup(tcfg.QuantizerConfig(**kw), ts,
                                       _t(x), train=True, draws=draws)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for ours, ref in ((tnew.embed, jnew.embed),
                      (tnew.cluster_size, jnew.cluster_size),
                      (tnew.embed_avg, jnew.embed_avg)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)
    replaced = int((tnew.cluster_size == 0.9).sum())
    assert 0 < replaced < 32
    assert replaced == int(jnp.sum(jnew.cluster_size == jnp.float32(0.9)))
    # without candidates (no draws) nothing expires, as with rng=None
    _, _, plain = tq.codebook_lookup(tcfg.QuantizerConfig(**kw), ts, _t(x),
                                     train=True)
    assert int((plain.cluster_size == 0.9).sum()) == 0


def test_draws_follow_the_options():
    """`draw_quantizer` draws only what the config turns on, from the
    generator it is given (the same seed, the same draws)."""
    base = tcfg.QuantizerConfig(codebook_size=16, dim=4)
    assert tq.draw_quantizer(base, 10, torch.Generator()) == \
        tq.QuantizerDraws()
    cfg = dataclasses.replace(base, sample_codebook_temp=1.0,
                              threshold_ema_dead_code=1.0,
                              orthogonal_reg_weight=1.0,
                              orthogonal_reg_max_codes=8)
    a = tq.draw_quantizer(cfg, 10, torch.Generator().manual_seed(4))
    b = tq.draw_quantizer(cfg, 10, torch.Generator().manual_seed(4))
    assert a.gumbel.shape == (10, 16) and torch.isfinite(a.gumbel).all()
    assert int(a.candidates.max()) < 10 and a.ortho_codes.shape == (8,)
    assert len(set(a.ortho_codes.tolist())) == 8
    for u, v in ((a.gumbel, b.gumbel), (a.candidates, b.candidates),
                 (a.ortho_codes, b.ortho_codes)):
        assert torch.equal(u, v)
