"""favae_tpu_torch's training-path modules against the JAX package's.

Same seeded numpy inputs, and the same weights carried across by
favae_tpu_torch.convert, through both packages on the CPU in f32 (the JAX
side at "highest" matmul precision, tests/conftest.py), unless a test says
otherwise: the quantizer's EMA and straight-through estimate, the Gaussian
blur with its sigma gradient, the matmul DFT, FFL and the feature-tap FFL,
the hinge losses, LPIPS and the discriminators in train mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import discriminator as jdisc
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.models.quantizer import CodebookState as JaxCodebookState
from favae_tpu.models.quantizer import VectorQuantize as JaxVQ
from favae_tpu.models.quantizer import codebook_lookup as jax_lookup
from favae_tpu.ops import ffl as jffl
from favae_tpu.ops import losses as jlosses
from favae_tpu.ops.gaussian import gaussian_blur_nhwc as jax_blur
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import discriminator_state_dict, lpips_from_jax
from favae_tpu_torch.models import discriminator as tdisc
from favae_tpu_torch.models.lpips import LPIPS
from favae_tpu_torch.models.quantizer import (CodebookState, VectorQuantize,
                                              codebook_lookup)
from favae_tpu_torch.ops import ffl, losses
from favae_tpu_torch.ops.dft import dft2_real_nhwc
from favae_tpu_torch.ops.gaussian import gaussian_blur_nhwc


@pytest.fixture(autouse=True)
def _f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

def _codebook_case(cosine, seed, n=96, k=64, d=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    embed = rng.randn(k, d).astype(np.float32) * 0.5
    if cosine:
        embed = _unit(embed)
        scores = _unit(x).astype(np.float64) @ embed.T.astype(np.float64)
    else:
        diff = x[:, None].astype(np.float64) - embed[None]
        scores = -np.sum(diff * diff, axis=-1)
    top2 = np.sort(scores, axis=-1)[:, -2:]
    assert np.min(top2[:, 1] - top2[:, 0]) > 1e-5, "near-tie in the inputs"
    cluster = rng.rand(k).astype(np.float32)
    avg = (embed * rng.rand(k, 1)).astype(np.float32)
    return x, embed, cluster, avg


@pytest.mark.parametrize("cosine,stale", [(True, False), (False, False),
                                          (False, True)])
def test_codebook_ema_matches_jax(cosine, stale):
    """One train-mode lookup: codes, quantized vectors and the new EMA state
    (cosine: normalised means, empty bins keep their code; euclidean:
    embed_avg EMA + Laplace smoothing, or the stale embed_avg); atol 1e-6
    plus a few f32 ulps relative (the stale case divides to values ~100)."""
    x, embed, cluster, avg = _codebook_case(cosine, seed=1 + stale)
    kw = dict(codebook_size=64, dim=16, use_cosine_sim=cosine,
              compat_stale_embed_avg=stale)
    jq, iq, js = jax_lookup(
        jcfg.QuantizerConfig(**kw),
        JaxCodebookState(embed=jnp.asarray(embed),
                         cluster_size=jnp.asarray(cluster),
                         embed_avg=jnp.asarray(avg)),
        jnp.asarray(x), train=True)
    tq, it, ts = codebook_lookup(
        tcfg.QuantizerConfig(**kw),
        CodebookState(embed=_t(embed), cluster_size=_t(cluster),
                      embed_avg=_t(avg)), _t(x), train=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(iq))
    assert len(np.unique(np.asarray(iq))) < 64  # some bins stay empty
    for ours, ref in ((tq, jq), (ts.embed, js.embed),
                      (ts.cluster_size, js.cluster_size),
                      (ts.embed_avg, js.embed_avg)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


def test_quantizer_straight_through_and_commit_loss():
    """VectorQuantize(train=True): output, commitment loss, new state and
    the gradient at the input (the straight-through identity plus the
    commitment term) against the flax module; atol 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    _, embed, cluster, avg = _codebook_case(True, seed=4, n=32)
    w = rng.randn(2, 4, 4, 16).astype(np.float32)
    qcfg = dict(codebook_size=64, dim=16, commitment_weight=0.25)
    jstate = JaxCodebookState(embed=jnp.asarray(embed),
                              cluster_size=jnp.asarray(cluster),
                              embed_avg=jnp.asarray(avg))
    jmod = JaxVQ(jcfg.QuantizerConfig(**qcfg))

    def jloss(x):
        out, _, loss, state = jmod.apply({}, x, jstate, train=True)
        return jnp.sum(out * w) + loss, (out, loss, state)

    (_, (jout, jl, js)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))

    tmod = VectorQuantize(tcfg.QuantizerConfig(**qcfg))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    state = CodebookState(embed=_t(embed), cluster_size=_t(cluster),
                          embed_avg=_t(avg))
    out, _, loss, ts = tmod(xt, state, train=True)
    ((out * _t(w).permute(0, 3, 1, 2)).sum() + loss).backward()
    for ours, ref in ((out.detach().permute(0, 2, 3, 1), jout),
                      (loss.detach(), jl), (ts.embed, js.embed),
                      (ts.cluster_size, js.cluster_size),
                      (xt.grad.permute(0, 2, 3, 1), jgrad)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("field,value", [
    ("threshold_ema_dead_code", 0.5), ("kmeans_init", True),
    ("sample_codebook_temp", 1.0), ("orthogonal_reg_weight", 0.1)])
def test_quantizer_options_not_ported_raise(field, value):
    cfg = dataclasses.replace(tcfg.QuantizerConfig(codebook_size=8, dim=4),
                              **{field: value})
    state = CodebookState(embed=torch.randn(8, 4),
                          cluster_size=torch.zeros(8),
                          embed_avg=torch.zeros(8, 4))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        codebook_lookup(cfg, state, torch.randn(3, 4), train=True)


# ---------------------------------------------------------------------------
# blur, DFT, FFL, losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,sigma,hw", [(9, 3.0, (12, 10)), (3, 1.0, (12, 10)),
                                        (9, 3.0, (4, 3)), (9, 3.0, (1, 2))])
def test_gaussian_blur_and_sigma_grad_match_jax(k, sigma, hw):
    """Including maps smaller than the pad (expe5's 16x-downsampled taps at
    64 px), where jnp.pad reflects periodically."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, *hw, 8).astype(np.float32)
    w = rng.randn(2, *hw, 8).astype(np.float32)

    def jloss(x, s):
        y = jax_blur(x, k, s)
        return jnp.sum(y * w), y

    (_, jy), (jdx, jds) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jnp.float32(sigma))
    xt = _t(x).requires_grad_()
    st = torch.tensor(sigma, requires_grad=True)
    y = gaussian_blur_nhwc(xt, k, st)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(st.grad.item(), float(jds), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 8, 12, 5)])
def test_dft_matches_torch_fft(shape):
    """f32 spectra against torch.fft.fft2 (ortho) to 1e-5."""
    x = _t(np.random.RandomState(0).randn(*shape).astype(np.float32))
    re, im = dft2_real_nhwc(x)
    ref = torch.fft.fft2(x.double(), dim=(1, 2), norm="ortho")
    np.testing.assert_allclose(re.numpy(), ref.real.numpy(), atol=1e-5)
    np.testing.assert_allclose(im.numpy(), ref.imag.numpy(), atol=1e-5)


# bf16 spectra round each stage to 8 bits: FFL agrees to a few 1e-3 relative
FFL_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_focal_frequency_loss_and_grad_match_jax(dtype):
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 16, 16, 3).astype(np.float32)
    target = rng.randn(2, 16, 16, 3).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda p: jffl.focal_frequency_loss(p, jnp.asarray(target),
                                            compute_dtype=dtype))(
        jnp.asarray(pred))
    pt = _t(pred).requires_grad_()
    tl = ffl.focal_frequency_loss(pt, _t(target), compute_dtype=dtype)
    tl.backward()
    rtol = FFL_RTOL[dtype]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=rtol)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(pt.grad.numpy() / scale,
                               np.asarray(jg) / scale, atol=rtol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_tap_ffl_mirror_pairs_like_jax(dtype):
    """Four taps of different sizes, encoder i against decoder 3-i."""
    rng = np.random.RandomState(3)
    sizes = [(2, 16, 16, 4), (2, 8, 8, 8), (2, 4, 4, 8), (2, 4, 4, 6)]
    enc = [rng.randn(*s).astype(np.float32) for s in sizes]
    dec = [rng.randn(*s).astype(np.float32) for s in reversed(sizes)]
    jtot, jper = jffl.feature_tap_ffl([jnp.asarray(a) for a in enc],
                                      [jnp.asarray(a) for a in dec],
                                      loss_weight=0.01, compute_dtype=dtype)
    ttot, tper = ffl.feature_tap_ffl([_t(a) for a in enc],
                                     [_t(a) for a in dec], loss_weight=0.01,
                                     compute_dtype=dtype)
    rtol = FFL_RTOL[dtype]
    np.testing.assert_allclose(ttot.item(), float(jtot), rtol=rtol)
    np.testing.assert_allclose([t.item() for t in tper],
                               [float(t) for t in jper], rtol=rtol)


def test_ffl_matrix_options_match_jax():
    rng = np.random.RandomState(8)
    pred = rng.randn(2, 8, 8, 2).astype(np.float32)
    target = rng.randn(2, 8, 8, 2).astype(np.float32)
    for kw in (dict(log_matrix=True), dict(batch_matrix=True),
               dict(alpha=2.0)):
        ref = jffl.focal_frequency_loss(jnp.asarray(pred),
                                        jnp.asarray(target), **kw)
        ours = ffl.focal_frequency_loss(_t(pred), _t(target), **kw)
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5,
                                   err_msg=str(kw))


def test_gan_losses_match_jax():
    rng = np.random.RandomState(9)
    real = rng.randn(3, 5, 5, 1).astype(np.float32)
    fake = rng.randn(3, 5, 5, 1).astype(np.float32)
    np.testing.assert_allclose(losses.hinge_g_loss(_t(fake)).item(),
                               float(jlosses.hinge_g_loss(fake)), rtol=1e-6)
    for name in ("hinge_d_loss", "vanilla_d_loss", "least_square_d_loss"):
        ours = getattr(losses, name)(_t(real), _t(fake)).item()
        ref = float(getattr(jlosses, name)(real, fake))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# LPIPS and the discriminators
# ---------------------------------------------------------------------------

def test_lpips_features_and_dist_match_jax():
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    y = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    jmod = JaxLPIPS(dtype=jnp.float32)
    params = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(y))["params"])
    jfx = jmod.apply({"params": params}, jnp.asarray(x),
                     method=JaxLPIPS.features)
    jd, jg = jax.value_and_grad(lambda y: jnp.sum(jmod.apply(
        {"params": params}, jfx, y, method=JaxLPIPS.dist)))(jnp.asarray(y))

    tmod = LPIPS(torch.float32)
    tmod.load_state_dict(lpips_from_jax(params), strict=True)
    fx = tmod.features(_t(x))
    for ours, ref in zip(fx, jfx):
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), atol=1e-5)
    yt = _t(y).requires_grad_()
    d = tmod.dist(fx, yt)
    d.sum().backward()
    assert d.shape == (2,)
    np.testing.assert_allclose(d.sum().item(), float(jd), rtol=1e-4)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(yt.grad.numpy() / scale,
                               np.asarray(jg) / scale, atol=1e-4)
    assert not any(p.requires_grad for p in tmod.parameters())


def _disc_modules(kind):
    dc = dict(kind=kind, num_layers=2, base_channels=16)
    jd = jdisc.build_discriminator(jcfg.DiscriminatorConfig(**dc),
                                   dtype=jnp.float32)
    x0 = jnp.zeros((2, 32, 32, 3), jnp.float32)
    v = _np_tree(jd.init(jax.random.PRNGKey(1), x0, train=False))
    # non-trivial running statistics to carry across
    stats = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.1), v["batch_stats"])
    cfg = tcfg.VQGANConfig(discriminator=tcfg.DiscriminatorConfig(**dc))
    td = tdisc.build_discriminator(cfg.discriminator, torch.float32)
    sd = discriminator_state_dict(v["params"], stats, cfg)
    prefix = "discriminator."
    td.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v_))
                        for k, v_ in sd.items()}, strict=True)
    return jd, v["params"], stats, td


@pytest.mark.parametrize("kind", ["conv", "patch"])
def test_discriminator_train_mode_matches_jax(kind):
    """Logits, input gradient and the updated BatchNorm running statistics
    (unbiased variance, momentum 0.1) of two train-mode forwards, then an
    eval-mode forward on the running statistics; atol 1e-5."""
    jd, params, stats, td = _disc_modules(kind)
    rng = np.random.RandomState(6)
    xs = [rng.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2)]
    td.train()
    for x in xs:
        def jloss(x, stats=stats):
            out, mut = jd.apply({"params": params, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, mut["batch_stats"])

        (_, (jout, stats)), jg = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(x))
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
        out = td(xt)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jout), atol=1e-5)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jg), atol=1e-5)
    norms = [m for m in td.modules() if isinstance(m, tdisc.TorchBatchNorm)]
    jstats = [stats[k] for k in sorted(stats)]
    assert len(norms) == len(jstats) == 2
    for m, s in zip(norms, jstats):
        np.testing.assert_allclose(m.running_mean.numpy(), s["mean"],
                                   atol=1e-6)
        np.testing.assert_allclose(m.running_var.numpy(), s["var"], atol=1e-6)
    td.eval()
    jout = jd.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(xs[0]), train=False)
    with torch.no_grad():
        out = td(_t(xs[0]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout), atol=1e-5)
