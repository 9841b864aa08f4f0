"""Shared set-up of the FA-VAE train-step parity tests
(`tests/test_torch_port_train*.py`).

Both packages start from one state: the JAX `FavaeTrainState.create` at the
tiny config of tests/test_train_step.py (FCM(Res), non-pairwise DSL, cosine
codebook, conv discriminator, f32, dropout 0), carried into the port by
favae_tpu_torch.convert (model, discriminator BatchNorm statistics, codebook
state, LPIPS). Each step runs on the same numpy batch, and after each step
the states are compared: losses and weight_d within 1e-4 relative; the
codebook EMA state and BatchNorm running statistics within 1e-5;
parameters within 2 lr at most and 0.01 lr on average, since Adam moves
every parameter by about lr * sign(g) and a gradient within rounding of
zero may take either sign. Then the port's model takes the JAX package's
parameters and buffers (its Adam moments stay its own), so the next step
tests the step again rather than the GAN's amplification of those flips:
left to run on, two f32 trajectories of this model drift apart by about
0.1 lr a parameter at the second step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.train.favae_state import FavaeTrainState as JaxState
from favae_tpu.train.favae_state import merge_params
from favae_tpu.train.favae_step import make_train_step as jax_train_step
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import from_jax_params, lpips_from_jax
from favae_tpu_torch.models.vqgan import VQGANFCM
from favae_tpu_torch.train.favae_state import FavaeTrainState
from favae_tpu_torch.train.favae_step import make_train_step

LR = 1e-4
LOSS_KEYS = ("loss_g", "loss_l1", "loss_perceptual", "loss_recon", "loss_q",
             "loss_disc", "weight_d", "loss_ffl", "loss_dsl_features",
             "loss_d", "cb_batch_usage_pct", "cb_perplexity")


@pytest.fixture(autouse=True)
def f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cfgs(m):
    model = m.VQGANConfig(
        codec=m.CodecConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(), resolution=32, z_channels=64),
        quantizer=m.QuantizerConfig(codebook_size=64, dim=64,
                                    use_cosine_sim=True),
        discriminator=m.DiscriminatorConfig(kind="conv", num_layers=2),
        fcm_kind="res", dsl_mode="nonpair", compute_dtype="float32")
    losses = m.LossConfig(gaussian_kernel=3, dsl_init_sigma=1.0,
                          disc_start_epochs=0, ffl_start_epochs=0)
    return model, losses, m.TrainConfig(batch_size=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state_dict(state, cfg):
    """A JAX train state's model as the port's state_dict (numpy)."""
    params = _np_tree(merge_params(state.params_g, state.params_d))
    sd = from_jax_params(params, _np_tree(state.cb_state), cfg,
                         _np_tree(state.batch_stats))
    return {k: v.numpy() for k, v in sd.items()}


def start():
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
    lpips = JaxLPIPS(dtype=jnp.float32)

    @functools.lru_cache(maxsize=None)
    def jstep(disc_on, ffl_on):
        return jax.jit(jax_train_step(jmodel, lpips, tx_g, tx_d, jm, jl, jt,
                                      disc_on=disc_on, ffl_on=ffl_on))

    def tstep(disc_on, ffl_on):
        return make_train_step(tm, tl, tt, disc_on=disc_on, ffl_on=ffl_on)

    return jstate, tstate, jstep, tstep, tm


def batch(seed):
    return (np.random.RandomState(seed).rand(4, 32, 32, 3) * 2 - 1).astype(
        np.float32)


def _compare_metrics(jm, tm, step):
    for k in LOSS_KEYS:
        if k not in jm:  # loss_ffl and loss_dsl_features with ffl_on off
            assert k not in tm
            continue
        ref, ours = float(jm[k]), float(tm[k])
        assert np.isfinite(ours), (step, k)
        assert abs(ours - ref) <= 1e-4 * abs(ref) + 1e-7, \
            f"step {step} {k}: port {ours} jax {ref}"


def _compare_and_sync(jstate, tstate, cfg):
    """Compare the two models after a step, then give the port the JAX
    package's parameters and buffers."""
    ref = _jax_state_dict(jstate, cfg)
    ours = {k: v.detach().numpy() for k, v in
            tstate.model.state_dict().items()}
    assert ref.keys() == ours.keys()
    errs = []
    for k in ref:
        if k.endswith("num_batches_tracked"):  # the JAX package has none
            continue
        err = np.abs(ours[k].astype(np.float64) - ref[k])
        if k.startswith("quantizer.") or "running_" in k:
            assert err.max() <= 1e-5, f"{k}: {err.max()}"
        else:
            errs.append(err.ravel())
            assert err.max() <= 2 * LR, f"{k}: {err.max()}"
    assert np.concatenate(errs).mean() <= 0.01 * LR
    tstate.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in ref.items()})


def run_gates(gates):
    """One step a (disc_on, ffl_on) pair of `gates` in both packages, each
    compared and the port then synced to the JAX state."""
    jstate, tstate, jstep, tstep, cfg = start()
    for i, (disc_on, ffl_on) in enumerate(gates):
        x = batch(10 + i)
        jstate, jm = jstep(disc_on, ffl_on)(jstate, jnp.asarray(x),
                                           jax.random.PRNGKey(1))
        tstate, tm = tstep(disc_on, ffl_on)(tstate, torch.from_numpy(x))
        _compare_metrics(jm, tm, i)
        np.testing.assert_allclose(tm["x_recon"].numpy(),
                                   np.asarray(jm["x_recon"]), atol=1e-4)
        _compare_and_sync(jstate, tstate, cfg)
    assert tstate.step == len(gates)
