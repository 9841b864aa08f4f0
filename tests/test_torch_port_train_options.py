"""The FA-VAE train options in the port's trainer, state and step against
the JAX package's, on the CPU.

- ActNorm's first-batch init (each layer's loc and scale from its input,
  later layers seeing initialised inputs): 1e-5 relative to each vector's
  largest entry.
- Both trainers' `_data_dependent_init` (k-means codebook and ActNorm)
  from one state and one batch, k-means from JAX's first permutation:
  the codebook state within 1e-5, ActNorm 1e-5 relative.
- bf16 Adam first moments (`adam_mu_dtype="bfloat16"`, the pairwise
  sigma group included) within lr * 2^-7 of optax's `mu_dtype` after 3
  steps of the same gradients.
- Two train steps with every codebook option on (gumbel sampling,
  dead-code expiry, the orthogonal regulariser on a sample of codes), the
  draws JAX's own: slice 2's bounds (tests/favae_train_common.py), and
  `cb_replaced` equal; the stage-1 recompute's codebook from one state,
  1e-5.
- A resume with k-means, expiry, the regulariser and bf16 moments on is
  bit for bit: `fit` for 2 epochs against 1 epoch, a new trainer,
  `resume()` and the second (the step generator is in the checkpoint).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import discriminator as jdisc
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu.train.favae_state import FavaeTrainState as JaxState
from favae_tpu.train.favae_state import make_generator_tx, merge_params
from favae_tpu.train.favae_step import make_train_step as jax_train_step
from favae_tpu.train.favae_trainer import FavaeTrainer as JaxTrainer
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import discriminator_state_dict, lpips_from_jax
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.models import discriminator as tdisc
from favae_tpu_torch.models.quantizer import QuantizerDraws
from favae_tpu_torch.models.vqgan import VQGANFCM
from favae_tpu_torch.train.favae_state import (FavaeTrainState, GroupAdam,
                                               make_optimizers)
from favae_tpu_torch.train.favae_step import make_train_step
from favae_tpu_torch.train.favae_trainer import FavaeTrainer
from tests.favae_train_common import (LR, _compare_and_sync,  # noqa: F401
                                      _compare_metrics, _jax_state_dict,
                                      _np_tree, batch, f32_torch)
from tests.test_torch_port_checkpoint import _assert_same_tree
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(ours, ref):
    """Largest error relative to the reference vector's largest entry (a
    channel's mean can cancel to near 0, where f32 summation order alone
    moves it by more than 1e-5 of itself)."""
    ref = np.asarray(ref, np.float64).ravel()
    err = np.abs(np.asarray(ours, np.float64).ravel() - ref)
    return float(err.max() / max(np.abs(ref).max(), 1e-30))


def _actnorms(td):
    return [m for m in td.modules() if isinstance(m, tdisc.ActNorm)]


def test_actnorm_data_init_matches_jax():
    """A 3-layer ActNorm PatchGAN: each ActNorm's loc = -mean and
    scale = 1/(std_ddof1 + 1e-6) of its input, computed with the layers
    before it already initialised; 1e-5 relative."""
    dc = dict(kind="patch", num_layers=3, base_channels=16, use_actnorm=True)
    jd = jdisc.build_discriminator(jcfg.DiscriminatorConfig(**dc),
                                   dtype=jnp.float32)
    x = np.random.RandomState(2).randn(2, 48, 48, 3).astype(np.float32)
    params = _np_tree(jd.init(jax.random.PRNGKey(1), jnp.asarray(x),
                              train=False))["params"]
    _, mut = jd.apply({"params": params}, jnp.asarray(x), data_init=True,
                      mutable=["actnorm_init"])
    sown = _np_tree(mut["actnorm_init"])
    cfg = tcfg.VQGANConfig(discriminator=tcfg.DiscriminatorConfig(**dc))
    td = tdisc.build_discriminator(cfg.discriminator, torch.float32)
    sd = discriminator_state_dict(params, {}, cfg)
    td.load_state_dict({k[len("discriminator."):]: torch.from_numpy(
        np.array(v)) for k, v in sd.items()}, strict=True)
    assert tdisc.actnorm_data_init_(td, _t(x).permute(0, 3, 1, 2)) == 3
    for i, layer in enumerate(_actnorms(td), start=1):
        ref = sown[f"norm_{i}"]
        assert _rel(layer.loc.detach().numpy(), ref["loc"]) <= 1e-5
        assert _rel(layer.scale.detach().numpy(), ref["scale"]) <= 1e-5
        assert not np.allclose(ref["scale"], 1.0)


def _option_cfgs(m, **quantizer):
    model = m.VQGANConfig(
        codec=m.CodecConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(), resolution=32, z_channels=64),
        quantizer=m.QuantizerConfig(codebook_size=64, dim=64,
                                    use_cosine_sim=True, **quantizer),
        discriminator=m.DiscriminatorConfig(kind="patch", num_layers=2,
                                            use_actnorm=True),
        fcm_kind="res", dsl_mode="nonpair", compute_dtype="float32")
    losses = m.LossConfig(gaussian_kernel=3, dsl_init_sigma=1.0,
                          disc_start_epochs=0, ffl_start_epochs=0)
    return model, losses, m.TrainConfig(batch_size=8)


def test_data_dependent_init_matches_jax(tmp_path):
    """k-means (4 iterations, 64 codes over 2048 codebook inputs) and the
    2 ActNorms of D(x_recon), both trainers from the JAX trainer's state
    on one batch of 8 (the JAX trainer's 8-device CPU mesh)."""
    q = dict(kmeans_init=True, kmeans_iters=4)
    jm, jl, jt = _option_cfgs(jcfg, **q)
    tm, tl, tt = _option_cfgs(tcfg, **q)
    jtr = JaxTrainer(jm, jl, jt, str(tmp_path / "jax"))
    ttr = FavaeTrainer(tm, tl, tt, str(tmp_path / "port"), device="cpu")
    ttr.state.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     _jax_state_dict(jtr.state, tm).items()})
    ds = SyntheticDataset(32, size=8, seed=5)
    x0 = np.stack([ds.get(i) for i in range(8)])
    _, key = jax.random.split(jtr.rng)  # the key the JAX init draws next
    first = _t(jax.random.permutation(key, 8 * 16 * 16)).long()
    jtr._data_dependent_init(x0)
    ttr._data_dependent_init(x0, first)
    ref = _jax_state_dict(jtr.state, tm)
    ours = ttr.state.model.state_dict()
    for k in ("quantizer._codebook.embed", "quantizer._codebook.cluster_size"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-5)
    assert ours["quantizer._codebook.cluster_size"].sum() == 2048
    layers = [k for k in ref if k.endswith((".loc", ".scale"))]
    assert len(layers) == 4
    for k in layers:
        assert _rel(ours[k].numpy(), ref[k]) <= 1e-5, k


def test_bf16_first_moments_match_optax():
    """GroupAdam with bf16 first moments against optax's mu_dtype chain
    (main lr and the pairwise-sigma group at sigma_lr), 3 steps of the
    same gradients: parameters within lr * 2^-7, moments stored bf16."""
    tc = tcfg.TrainConfig(adam_mu_dtype="bfloat16")
    jc = jcfg.TrainConfig(adam_mu_dtype="bfloat16")
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(6, 5).astype(np.float32),
          "sigmas": np.full((4,), 3.0, np.float32)}
    tx = make_generator_tx(jc, LR)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jopt = tx.init(jp)
    w, sig = (torch.nn.Parameter(_t(p0[k])) for k in ("w", "sigmas"))
    opt = GroupAdam([([w], LR), ([sig], tc.sigma_lr)], tc, torch.bfloat16)
    for step in range(3):
        g = {"w": rng.randn(6, 5).astype(np.float32),
             "sigmas": rng.randn(4).astype(np.float32)}
        upd, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt,
                              jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        w.grad, sig.grad = _t(g["w"]), _t(g["sigmas"])
        opt.step()
        for ours, k, lr in ((w, "w", LR), (sig, "sigmas", tc.sigma_lr)):
            err = np.abs(ours.detach().numpy() - np.asarray(jp[k])).max()
            assert err <= lr * 2 ** -7, (step, k, err)
    assert all(m.dtype == torch.bfloat16 for part, _ in opt.parts
               for m in part.mu)
    assert all(n.dtype == torch.float32 for part, _ in opt.parts
               for n in part.nu)
    model = VQGANFCM(_option_cfgs(tcfg)[0])
    opt_g, opt_d = make_optimizers(model, tc, LR)
    assert isinstance(opt_g, GroupAdam) and isinstance(opt_d, GroupAdam)


def _jax_draws(key, n, k, max_codes):
    """The quantizer draws the JAX step makes from one of its keys."""
    return QuantizerDraws(
        gumbel=_t(jax.random.gumbel(key, (n, k), jnp.float32)),
        candidates=_t(jax.random.randint(jax.random.fold_in(key, 1), (k,),
                                         0, n)).long(),
        ortho_codes=_t(jax.random.permutation(jax.random.fold_in(key, 2),
                                              k)[:max_codes]).long())


def test_two_steps_with_codebook_options_match_jax():
    """Gumbel sampling at temperature 1, expiry at threshold 3 and the
    regulariser (weight 10) on 16 of 64 codes, through both stages, twice;
    the draws are the JAX step's, from fold_in(key, step) split four ways
    (stage 0 the second, the recompute the third). The steps run without
    the stage-1 recompute: the generator it runs on differs between the
    packages by Adam's sign flips (up to 2 lr a parameter), and codes that
    expiry copied from this very batch put tokens a hair apart, so a few
    tokens change code there and the codebook bound of 1e-5 no longer
    tests the port. The recompute is held instead from one state after
    each step: the port synced to the JAX package's weights, both encode
    the batch in train mode with the recompute's draws."""
    q = dict(sample_codebook_temp=1.0, threshold_ema_dead_code=3.0,
             orthogonal_reg_weight=10.0, orthogonal_reg_max_codes=16)

    def cfgs(m):
        model, losses, train = _option_cfgs(m, **q)
        return (dataclasses.replace(model, discriminator=m.DiscriminatorConfig(
            kind="conv", num_layers=2)), losses,
            dataclasses.replace(train, batch_size=4,
                                faithful_stage1_recompute=False))

    jm, jl, jt = cfgs(jcfg)
    tm, tl, tt = cfgs(tcfg)
    jstate, jmodel, tx_g, tx_d = JaxState.create(jm, jl, jt,
                                                 jax.random.PRNGKey(0), lr=LR)
    model = VQGANFCM(tm, gaussian_kernel=3, dsl_init_sigma=1.0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _jax_state_dict(jstate, tm).items()}, strict=True)
    tstate = FavaeTrainState.create(
        tm, tl, tt, LR, model=model,
        lpips_state_dict=lpips_from_jax(_np_tree(jstate.lpips_params)))
    jstep = jax.jit(jax_train_step(jmodel, JaxLPIPS(dtype=jnp.float32), tx_g,
                                   tx_d, jm, jl, jt, disc_on=True,
                                   ffl_on=True))
    tstep = make_train_step(tm, tl, tt, disc_on=True, ffl_on=True)

    @jax.jit
    def jrecompute(state, x, key):
        gen = {"params": merge_params(state.params_g, state.params_d)}
        return jmodel.apply(gen, x, state.cb_state, train=True,
                            inference=True, rng=key,
                            method=JaxVQGAN.encode)[4]

    replaced = []
    for i in range(2):
        x = batch(10 + i)
        key = jax.random.PRNGKey(1)
        _, k_vq0, k_vq1, _ = jax.random.split(jax.random.fold_in(key, i), 4)
        draws = [_jax_draws(k, 4 * 16 * 16, 64, 16) for k in (k_vq0, k_vq1)]
        jstate, jmet = jstep(jstate, jnp.asarray(x), key)
        tstate, tmet = tstep(tstate, torch.from_numpy(x), draws)
        _compare_metrics(jmet, tmet, i)
        assert float(tmet["cb_replaced"]) == float(jmet["cb_replaced"])
        replaced.append(float(tmet["cb_replaced"]))
        _compare_and_sync(jstate, tstate, tm)
        ref = jrecompute(jstate, jnp.asarray(x), k_vq1)
        with torch.no_grad():
            ours = model.generate(torch.from_numpy(x), model.codebook_state(),
                                  train=True, inference=True,
                                  draws=draws[1])["cb_state"]
        for a, b in ((ours.embed, ref.embed),
                     (ours.cluster_size, ref.cluster_size)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert replaced[0] > 0


def _resume_trainer(save_dir):
    m, lc, tc = _option_cfgs(
        tcfg, kmeans_init=True, kmeans_iters=2, threshold_ema_dead_code=1.0,
        orthogonal_reg_weight=10.0, orthogonal_reg_max_codes=16)
    lc = dataclasses.replace(lc, disc_start_epochs=1)
    tc = tcfg.TrainConfig(batch_size=2, epochs=2, adam_mu_dtype="bfloat16")
    tr = FavaeTrainer(m, lc, tc, str(save_dir), device="cpu")
    train = DataLoader(SyntheticDataset(32, size=4, seed=1), 2,
                       num_workers=1, shuffle=True, seed=0)
    val = DataLoader(SyntheticDataset(32, size=2, seed=7), 2, num_workers=1)
    return tr, train, val


def test_resume_with_options_is_bitwise(tmp_path):
    full, train, val = _resume_trainer(tmp_path / "full")
    full.fit(train, val)
    half, train, val = _resume_trainer(tmp_path / "half")
    half.fit(train, val, epochs=1)
    again, train, val = _resume_trainer(tmp_path / "half")
    again.resume()
    assert again.start_epoch == 1
    again.fit(train, val)
    assert again.state.step == full.state.step == 4
    assert isinstance(again.state.opt_g, GroupAdam)
    assert again.state.opt_g.parts[0][0].mu[0].dtype == torch.bfloat16
    _assert_same_tree(again.state.state_dict(), full.state.state_dict())
    assert [h["loss_g"] for h in again.history] == \
        [h["loss_g"] for h in full.history[2:]]
    assert all(h["cb_replaced"] >= 0 for h in full.history)
    assert sum(h["cb_replaced"] for h in full.history) > 0
    # without the generator's state, the second epoch draws otherwise
    other, train, val = _resume_trainer(tmp_path / "half")
    other.resume()
    other.state.generator.manual_seed(123)
    other.fit(train, val)
    assert [h["loss_g"] for h in other.history] != \
        [h["loss_g"] for h in full.history[2:]]
