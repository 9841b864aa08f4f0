"""The serve slice of favae_tpu_torch as a whole, on the CPU: text ids ->
CLIP -> KV-cache sampler -> FA-VAE decode (`CATModel.sample_images`) against
the JAX package at the tiny CAT config of
tests/test_decode_step_kernel.py:74, and the `generate` CLI.

All three towers carry JAX's weights (`from_jax_params`,
`clip_text_from_jax`, `gpt_from_jax`) and the port is given JAX's own gumbel
noise. The GPT runs in bf16 on both sides, as `build_cat` builds it, so XLA's
and PyTorch's roundings may part on a few tokens: the grids must agree at
0.9 (the bound of the JAX package's own int8 tests). Given equal tokens the
f32 FA-VAE decode must give the same image to atol 1e-3 (the tolerance of the
reconstruction tests), which is checked by decoding JAX's grid in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models.txt_cond import build_cat as jax_build_cat
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import generate
from favae_tpu_torch.convert import (clip_text_from_jax, from_jax_params,
                                     gpt_from_jax)
from favae_tpu_torch.models.txt_cond import build_cat
from favae_tpu_torch.ops import decode_step_kernel as dk

AGREEMENT = 0.9


def _cat_cfg(C, n_head=2, clip_vocab=100):
    vq = C.VQGANConfig(
        codec=C.codec_for_downsample_factor(4, z_channels=8, base_channels=32,
                                            resolution=32),
        quantizer=C.QuantizerConfig(codebook_size=64, dim=8,
                                    use_cosine_sim=True),
        discriminator=C.DiscriminatorConfig(base_channels=32),
        fcm_kind="none", dsl_mode="none", compute_dtype="float32")
    gpt = C.GPTConfig(vocab_size=64, n_layer=2, n_embed=128, n_head=n_head,
                      dim_head=64, n_cond_embed=64, image_encoded_dim=8,
                      max_text_len=7, dropout=0.0)
    clip = C.CLIPTextConfig(context_length=7, vocab_size=clip_vocab, width=64,
                            heads=2, layers=2, embed_dim=64)
    return C.CATConfig(vqgan=vq, clip=clip, gpt=gpt)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cats():
    jmodel, gpt_params = jax_build_cat(_cat_cfg(jcfg), jax.random.PRNGKey(0))
    cfg = _cat_cfg(tcfg)
    ours = build_cat(cfg, "cpu")
    ours.favae.load_state_dict(from_jax_params(
        _np_tree(jmodel.favae_variables["params"]), _np_tree(jmodel.cb_state),
        cfg.vqgan, _np_tree(jmodel.favae_variables.get("batch_stats"))))
    ours.clip.load_state_dict(clip_text_from_jax(_np_tree(jmodel.clip_params)))
    ours.gpt.load_state_dict(gpt_from_jax(_np_tree(gpt_params)))
    return jmodel, gpt_params, ours


def jax_gumbel_noise(key, seq_len, b, vocab):
    out = []
    for _ in range(seq_len):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (b, vocab),
                                              dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out))


def test_encode_text_ids_matches_jax(cats):
    jmodel, _, ours = cats
    ids = np.random.RandomState(0).randint(0, 90, (3, 7))
    ref_e, ref_m = jmodel.encode_text_ids(jnp.asarray(ids, jnp.int32))
    e, m = ours.encode_text_ids(torch.from_numpy(ids))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(e.numpy(), np.asarray(ref_e), atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b", [1, 4])
def test_sample_images_matches_jax(cats, quantized, b):
    """B 1 exercises the padding of the prompt batch to 4 (8 CFG rows) on the
    quantized route, which here is the fused one (`supports` is true)."""
    jmodel, gpt_params, ours = cats
    assert dk.supports(ours.cfg.gpt, 8)
    ids = np.random.RandomState(b).randint(1, 90, (b, 7))
    ids[0, 5:] = 0
    key = jax.random.PRNGKey(1)
    kw = dict(top_k=32, top_p=0.95, cond_scale=3.0)
    ref_imgs, ref_grid = jmodel.sample_images(
        gpt_params, jnp.asarray(ids, jnp.int32), rng=key, quantized=quantized,
        **kw)
    ref_imgs, ref_grid = np.asarray(ref_imgs), np.asarray(ref_grid)

    b_noise = max(4, -(-b // 4) * 4) if quantized else b
    noise = jax_gumbel_noise(key, 64, b_noise, 64)
    imgs, grid = ours.sample_images(torch.from_numpy(ids), quantized=quantized,
                                    gumbel_noise=noise, **kw)
    assert imgs.shape == (b, 32, 32, 3) and grid.shape == (b, 8, 8)
    assert torch.isfinite(imgs).all()
    agree = float((grid.numpy() == ref_grid).mean())
    assert agree >= AGREEMENT, f"token agreement {agree}"
    same = (grid.numpy() == ref_grid).reshape(b, -1).all(axis=1)
    np.testing.assert_allclose(imgs.numpy()[same], ref_imgs[same], atol=1e-3,
                               rtol=0)
    decoded = ours.decode_to_img(torch.from_numpy(ref_grid.copy()).long())
    np.testing.assert_allclose(decoded.numpy(), ref_imgs, atol=1e-3, rtol=0)


def test_quantized_route_follows_supports():
    """n_head 4 x 64 > n_embed 128: `supports` is false, the FFN-only route
    runs, and the batch is not padded."""
    cfg = _cat_cfg(tcfg, n_head=4)
    assert not dk.supports(cfg.gpt, 8)
    ours = build_cat(cfg, "cpu")
    assert ours.serving_route(1, True) == ("ffn_int8", 1)
    assert ours.serving_route(1, False) == ("exact", 1)
    assert build_cat(_cat_cfg(tcfg), "cpu").serving_route(5, True) == (
        "fused", 8)
    ids = torch.from_numpy(np.random.RandomState(2).randint(1, 90, (1, 7)))
    noise = torch.from_numpy(np.random.RandomState(3).gumbel(
        size=(64, 1, 64)).astype(np.float32))
    timings = {}
    imgs, grid = ours.sample_images(ids, quantized=True, gumbel_noise=noise,
                                    top_k=16, timings=timings)
    assert imgs.shape == (1, 32, 32, 3) and grid.shape == (1, 8, 8)
    assert len(timings["token_ms"]) == 64
    assert all(timings[k] >= 0 for k in ("clip", "prepare", "tokens",
                                         "decode"))
    assert timings["tokens"] * 1e3 >= sum(timings["token_ms"])


def test_encode_to_z_and_tokenize(cats):
    _, _, ours = cats
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 32, 32, 3)
                         .astype(np.float32) * 2 - 1)
    z = ours.encode_to_z(x)
    assert z.shape == (2, 64) and 0 <= int(z.min()) and int(z.max()) < 64
    with pytest.raises(ValueError, match="merges"):
        ours.tokenize(["a face"])


def test_generate_cli_on_cpu(tmp_path):
    out = tmp_path / "samples.npz"
    res = generate.main(
        ["--prompt", "a face", "--prompt", "sy", "--n", "2", "--device", "cpu",
         "--top_k", "16", "--quantized", "--out", str(out)],
        cfg=_cat_cfg(tcfg, clip_vocab=49408))  # the BPE tokenizer's ids
    saved = np.load(out, allow_pickle=True)
    assert saved["images"].shape == (4, 32, 32, 3)
    assert saved["tokens"].shape == (4, 8, 8)
    assert list(saved["prompts"]) == ["a face", "a face", "sy", "sy"]
    assert saved["images"].min() >= 0 and saved["images"].max() <= 1
    assert res["route"] == "fused" and res["images"].shape == (4, 32, 32, 3)
    for k in ("clip_ms", "decode_ms", "first_token_ms", "ms_per_token",
              "tokens_per_s", "images_per_s"):
        assert np.isfinite(res[k]) and res[k] > 0, k


def test_generate_cli_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        generate.main(["--prompt", "x", "--device", "cpu", "--ckpt", "dir"])


@pytest.mark.parametrize("name,n_layer,n_embed,n_head,route", [
    ("gpt2_medium", 24, 1536, 16, "fused"),
    ("gpt2_mini", 24, 1536, 24, "fused"),
    ("gpt2_large", 36, 1280, 32, "ffn_int8")])
def test_resolve_cfg_and_the_route_it_gets(name, n_layer, n_embed, n_head,
                                          route):
    cfg = generate.resolve_cfg(1024, 256, name)
    g = cfg.gpt
    assert (g.n_layer, g.n_embed, g.n_head, g.vocab_size) == (
        n_layer, n_embed, n_head, 1024)
    assert dk.supports(g, 8) == (route == "fused")
    other = generate.resolve_cfg(512, 128, name)
    assert other.gpt.vocab_size == 512
    assert other.vqgan.quantizer.codebook_size == 512
    assert other.vqgan.quantizer.dim == 128
