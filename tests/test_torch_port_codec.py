"""favae_tpu_torch blocks, Encoder and Decoder against the flax modules.

Same seeded numpy inputs and the same weights (flax init, carried across by
favae_tpu_torch.convert) through both packages at a tiny config, in f32 on
the CPU: the JAX side at "highest" matmul precision (tests/conftest.py), the
port with TF32 off. Tolerance atol 1e-4 on outputs and taps: both sides
compute the same f32 math, summed in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import blocks as jblocks
from favae_tpu.models.quantizer import init_codebook_state
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import block_state_dict, from_jax_params
from favae_tpu_torch.models import blocks as tblocks
from favae_tpu_torch.models.vqgan import VQGANFCM

ATOL = 1e-4
TINY = dict(
    codec=dict(base_channels=64, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(8,), resolution=16, z_channels=32),
    quantizer=dict(codebook_size=64, dim=32, use_cosine_sim=True))


@pytest.fixture(autouse=True)
def _f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(fcm_kind, dsl_mode, **quantizer):
    """The same tiny VQGANConfig in both packages."""
    out = []
    for m in (jcfg, tcfg):
        out.append(m.VQGANConfig(
            codec=m.CodecConfig(**TINY["codec"]),
            quantizer=m.QuantizerConfig(**{**TINY["quantizer"], **quantizer}),
            fcm_kind=fcm_kind, dsl_mode=dsl_mode, compute_dtype="float32"))
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _close(ours, ref, what):
    ours = ours.detach()
    if ours.dim() == 4:
        ours = ours.permute(0, 2, 3, 1)
    err = np.max(np.abs(ours.numpy() - np.asarray(ref)))
    assert err < ATOL, f"{what}: max abs err {err}"


BLOCKS = {
    "resnet_shortcut": (lambda: jblocks.ResnetBlock(128, dtype=jnp.float32),
                        lambda: tblocks.ResnetBlock(64, 128,
                                                    dtype=torch.float32), 64),
    "resnet": (lambda: jblocks.ResnetBlock(64, dtype=jnp.float32),
               lambda: tblocks.ResnetBlock(64, 64, dtype=torch.float32), 64),
    "nonresnet_16_groups": (
        lambda: jblocks.NonResnetBlock(64, num_groups=16, dtype=jnp.float32),
        lambda: tblocks.NonResnetBlock(64, 16, dtype=torch.float32), 64),
    "attn": (lambda: jblocks.AttnBlock(128, dtype=jnp.float32),
             lambda: tblocks.AttnBlock(128, dtype=torch.float32), 128),
    "trans_encoder": (
        lambda: jblocks.TransEncoderBlock(128, dtype=jnp.float32),
        lambda: tblocks.TransEncoderBlock(128, dtype=torch.float32), 128),
    "upsample": (lambda: jblocks.Upsample(64, dtype=jnp.float32),
                 lambda: tblocks.Upsample(64, dtype=torch.float32), 64),
    "downsample": (lambda: jblocks.Downsample(64, dtype=jnp.float32),
                   lambda: tblocks.Downsample(64, dtype=torch.float32), 64),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    make_jax, make_torch, cin = BLOCKS[name]
    x = np.random.RandomState(1).randn(2, 8, 8, cin).astype(np.float32)
    jmod = make_jax()
    params = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = jmod.apply({"params": params}, jnp.asarray(x))

    tmod = make_torch().eval()
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in block_state_dict(params).items()}
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tmod(_nchw(x))
    _close(out, ref, name)


# every fcm_kind x dsl mode of tests/test_torch_parity.py, plus fcm none
MODES = [("res", "nonpair"), ("conv", "pair"), ("attn", "nonpair"),
         ("conv", "none"), ("none", "none")]


def _models(fcm_kind, dsl_mode):
    jc, tc = _cfgs(fcm_kind, dsl_mode)
    jmodel = JaxVQGAN(jc)
    key = jax.random.PRNGKey(3)
    cb = init_codebook_state(jc.quantizer, key)
    dummy = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = _np_tree(jmodel.init({"params": key, "dropout": key}, dummy, cb,
                                  train=False)["params"])
    tmodel = VQGANFCM(tc).eval()
    tmodel.load_state_dict(from_jax_params(params, _np_tree(cb), tc),
                           strict=True)
    return jmodel, params, cb, tmodel


@pytest.mark.parametrize("fcm_kind,dsl_mode", MODES)
def test_encoder_decoder_match_flax(fcm_kind, dsl_mode):
    jmodel, params, _, tmodel = _models(fcm_kind, dsl_mode)
    rng = np.random.RandomState(4)
    x = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    z = rng.randn(2, 8, 8, 32).astype(np.float32)

    z_ref, taps_ref = jmodel.apply(
        {"params": params}, jnp.asarray(x),
        method=lambda m, x: m.encoder(x, train=False, inference=True))
    x_ref, dtaps_ref, hpre_ref = jmodel.apply(
        {"params": params}, jnp.asarray(z),
        method=lambda m, z: m.decoder(z, train=False, inference=True))

    with torch.no_grad():
        z_out, taps = tmodel.encoder(_nchw(x))
        x_out, dtaps, h_pre = tmodel.decoder(_nchw(z))
    _close(z_out, z_ref, "encoder z")
    assert len(taps) == len(taps_ref) == 4
    for i, (t, r) in enumerate(zip(taps, taps_ref)):
        _close(t, r, f"encoder tap {i}")
    _close(x_out, x_ref, "decoder x")
    _close(h_pre, hpre_ref, "decoder h_pre")
    assert len(dtaps) == len(dtaps_ref) == 4
    for i, (t, r) in enumerate(zip(dtaps, dtaps_ref)):
        _close(t, r, f"decoder tap {i}")


def test_configs_are_copies():
    """The port's config module is a copy of the JAX package's."""
    for name in jcfg.PRESETS:
        assert dataclasses.asdict(jcfg.PRESETS[name]()) == \
            dataclasses.asdict(tcfg.PRESETS[name]()), name
