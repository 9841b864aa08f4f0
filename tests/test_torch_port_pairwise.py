"""Pairwise DSL in favae_tpu_torch against the JAX package: the model-level
sigmas' tap blur and their optimizer group.

The flax model's weights carried into the port by favae_tpu_torch.convert,
on the CPU in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from favae_tpu import config as jcfg
from favae_tpu.models.quantizer import init_codebook_state
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import from_jax_params
from favae_tpu_torch.models.vqgan import VQGANFCM
from favae_tpu_torch.train.favae_state import FavaeTrainState
from favae_tpu_torch.train.favae_step import make_train_step

LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_pairwise_dsl_blur_and_sigma_group():
    """Pairwise DSL: the model-level sigmas blur encoder tap i and decoder
    tap j as the flax model does (f32, atol 1e-5), sit in an Adam group of
    their own at sigma_lr, and move by less than 1e-5 in a step."""
    jcfg_pair = jcfg.VQGANConfig(
        codec=jcfg.CodecConfig(base_channels=32, ch_mult=(1, 2),
                               num_res_blocks=1, attn_resolutions=(),
                               resolution=16, z_channels=32),
        quantizer=jcfg.QuantizerConfig(codebook_size=16, dim=32),
        discriminator=jcfg.DiscriminatorConfig(num_layers=2),
        fcm_kind="conv", dsl_mode="pair", compute_dtype="float32")
    tcfg_pair = tcfg.VQGANConfig(
        codec=tcfg.CodecConfig(**jcfg_pair.codec.__dict__),
        quantizer=tcfg.QuantizerConfig(codebook_size=16, dim=32),
        discriminator=tcfg.DiscriminatorConfig(num_layers=2),
        fcm_kind="conv", dsl_mode="pair", compute_dtype="float32")
    tl = tcfg.LossConfig(gaussian_kernel=3, dsl_init_sigma=1.0,
                         disc_start_epochs=0, ffl_start_epochs=0)
    jmodel = JaxVQGAN(jcfg_pair, gaussian_kernel=3, dsl_init_sigma=1.0)
    key = jax.random.PRNGKey(2)
    cb = init_codebook_state(jcfg_pair.quantizer, key)
    params = _np_tree(jmodel.init({"params": key, "dropout": key},
                                  jnp.zeros((1, 16, 16, 3)), cb,
                                  train=False)["params"])
    params["sigmas"] = np.asarray([0.7, 1.0, 1.3, 1.6], np.float32)
    rng = np.random.RandomState(7)
    enc = [rng.randn(2, s, s, 8).astype(np.float32) for s in (16, 8, 8, 8)]
    dec = [rng.randn(2, s, s, 8).astype(np.float32) for s in (8, 8, 8, 16)]
    jenc, jdec = jmodel.apply({"params": params}, enc, dec,
                              method=JaxVQGAN.blur_taps_pairwise)

    model = VQGANFCM(tcfg_pair, gaussian_kernel=3, dsl_init_sigma=1.0)
    model.load_state_dict(from_jax_params(params, _np_tree(cb), tcfg_pair),
                          strict=True)
    tenc, tdec = model.blur_taps_pairwise([torch.from_numpy(a) for a in enc],
                                          [torch.from_numpy(a) for a in dec])
    for ours, ref in zip(tenc + tdec, list(jenc) + list(jdec)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   atol=1e-5)

    tt = tcfg.TrainConfig(batch_size=2)
    state = FavaeTrainState.create(tcfg_pair, tl, tt, LR, model=model)
    groups = state.opt_g.param_groups
    assert [g["lr"] for g in groups] == [LR, tt.sigma_lr]
    assert groups[1]["params"] == [model.sigmas]
    before = model.sigmas.detach().clone()
    x = torch.from_numpy((rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32))
    make_train_step(tcfg_pair, tl, tt, disc_on=True, ffl_on=True)(state, x)
    moved = (model.sigmas.detach() - before).abs()
    assert (moved > 0).any() and moved.max() < 1e-5
