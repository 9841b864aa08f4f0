"""Shared set-up of the CAT training parity tests
(`tests/test_torch_port_cat_train_*.py`): a tiny CAT configuration (a
2-layer GPT of width 64 over a 4 x 4 token grid, an f16 FA-VAE at 64 px
with a cosine codebook of 64 codes, a 2-layer CLIP text tower), built in
f32 in both packages, the port carrying the JAX package's weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import gpt as jgpt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import (clip_text_from_jax, from_jax_params,
                                     gpt_from_jax)
from favae_tpu_torch.models.gpt import GPT
from favae_tpu_torch.models.txt_cond import build_cat

MERGES = ["s y", "sy n", "syn t"]


def tiny_cfg(C, dropout=0.0, cond_drop_prob=0.25, **cat_over):
    vq = C.VQGANConfig(
        codec=C.codec_for_downsample_factor(16, z_channels=32,
                                            base_channels=32, resolution=64,
                                            num_groups=8),
        quantizer=C.QuantizerConfig(codebook_size=64, dim=32,
                                    use_cosine_sim=True),
        discriminator=C.DiscriminatorConfig(base_channels=32),
        fcm_kind="res", dsl_mode="pair", compute_dtype="float32")
    gpt = C.GPTConfig(vocab_size=64, n_layer=2, n_embed=64, n_head=4,
                      dim_head=16, n_cond_embed=32, image_encoded_dim=4,
                      max_text_len=8, dropout=dropout,
                      cond_drop_prob=cond_drop_prob, remat="none")
    clip = C.CLIPTextConfig(context_length=8, vocab_size=600, width=32,
                            heads=2, layers=2, embed_dim=32)
    return C.CATConfig(vqgan=vq, clip=clip, gpt=gpt, epochs=1,
                       warmup_epochs=0, **cat_over)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_gpt(cfg, params) -> GPT:
    gpt = GPT(cfg.gpt, dtype=torch.float32)
    gpt.load_state_dict(gpt_from_jax(np_tree(params)), strict=True)
    return gpt


def _jax_favae_variables(cfg, seed):
    """Seeded numpy weights in the FA-VAE's variable tree (shapes from
    `jax.eval_shape` of its init: compiling the init itself takes ~15 s):
    kernels ~ N(0, 1/fan_in), norm scales ~1, biases small, the DSL sigmas
    at their init, fresh BatchNorm statistics."""
    from favae_tpu.models.quantizer import init_codebook_state
    from favae_tpu.models.vqgan import VQGANFCM
    model = VQGANFCM(cfg.vqgan)
    cb = init_codebook_state(cfg.vqgan.quantizer, jax.random.PRNGKey(seed))
    res = cfg.vqgan.codec.resolution
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k, "dropout": k},
                             jnp.zeros((1, res, res, 3)), cb, train=False,
                             inference=True), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "sigmas" in name:
            return jnp.full(shape, 3.0, jnp.float32)
        if "batch_stats" in name:
            return jnp.full(shape, 1.0 if "var" in name else 0.0, jnp.float32)
        if "scale" in name:
            a = 1 + 0.1 * rng.randn(*shape)
        elif "bias" in name or len(shape) < 2:
            a = 0.05 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes), cb


def both_cats(seed=0, **kw):
    """(JAX CATModel with an f32 GPT, its GPT params, the port's CATModel
    with the same weights, the port's config)."""
    jc, tc = tiny_cfg(jcfg, **kw), tiny_cfg(tcfg, **kw)
    from favae_tpu.models.clip_text import BPETokenizer as JaxTokenizer
    from favae_tpu_torch.models.clip_text import BPETokenizer
    from favae_tpu.models.clip_text import CLIPTextEncoder
    from favae_tpu.models.txt_cond import CATModel
    from favae_tpu.models.vqgan import VQGANFCM
    fv, cb = _jax_favae_variables(jc, seed)
    k_clip, k_gpt = jax.random.split(jax.random.PRNGKey(seed))
    clip = CLIPTextEncoder(jc.clip)
    ctx = jc.clip.context_length
    clip_params = jax.jit(lambda k: clip.init(
        k, jnp.zeros((1, ctx), jnp.int32)))(k_clip)["params"]
    gpt = jgpt.GPT(jc.gpt, dtype=jnp.float32)
    n = jc.gpt.image_encoded_dim ** 2
    params = jax.jit(lambda k: gpt.init(
        k, jnp.zeros((1, n - 1), jnp.int32),
        jnp.zeros((1, ctx, jc.gpt.n_cond_embed)), jnp.ones((1, ctx), bool),
        cond_drop_prob=0.0))(k_gpt)["params"]
    jmodel = CATModel(cfg=jc, favae=VQGANFCM(jc.vqgan), favae_variables=fv,
                      cb_state=cb, clip=clip, clip_params=clip_params,
                      gpt=gpt, tokenizer=JaxTokenizer(merges=MERGES))
    ours = build_cat(tc, "cpu", tokenizer=BPETokenizer(merges=MERGES))
    ours.favae.load_state_dict(from_jax_params(
        np_tree(jmodel.favae_variables["params"]), np_tree(jmodel.cb_state),
        tc.vqgan, np_tree(jmodel.favae_variables.get("batch_stats"))))
    ours.clip.load_state_dict(clip_text_from_jax(np_tree(jmodel.clip_params)))
    ours.gpt = port_gpt(tc, params)
    return jmodel, params, ours, tc


def port_cat(seed=0, **kw):
    """The port's CATModel alone at the tiny configuration, seeded random
    weights, an f32 GPT: for the properties the port holds by itself."""
    from favae_tpu_torch.models.clip_text import BPETokenizer
    tc = tiny_cfg(tcfg, **kw)
    ours = build_cat(tc, "cpu", seed=seed,
                     tokenizer=BPETokenizer(merges=MERGES))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ours.gpt = GPT(tc.gpt, dtype=torch.float32)
    return ours, tc


def batch(b=4, seed=0):
    """Images (b, 64, 64, 3) in [-1, 1] and CLIP ids (b, 8), numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, 64, 64, 3) * 2 - 1).astype(np.float32)
    ids = rng.randint(1, 600, (b, 8)).astype(np.int32)
    ids[0, 5:] = 0
    return x, ids


def jax_keep(step_rng, step, b, p=0.25):
    """The conditioning keep mask of JAX's train step number `step`
    (cat_step.py:155-160 -> txt_cond.py:128 -> gpt.py:515-519)."""
    r = jax.random.fold_in(jax.random.fold_in(step_rng, step), 17)
    return torch.from_numpy(np.array(jax.random.uniform(r, (b,)) < 1.0 - p))
