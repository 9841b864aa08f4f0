"""favae_tpu_torch's GPT and CLIP text tower against the JAX package, on
the CPU in f32 (JAX at "highest" matmul precision): the same weights,
carried across with `gpt_from_jax` / `clip_text_from_jax`, and the same
seeded numpy inputs. Logits and embeddings must agree to atol 1e-4: both
sides compute in f32 and differ in summation order and in LayerNorm's
variance form (the flax LayerNorm uses E[x^2] - E[x]^2, PyTorch's two
passes), about 1e-6 on values of order 1 to 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import clip_text as jclip
from favae_tpu.models import gpt as jgpt
from favae_tpu.utils.torch_export import export_cat_gpt, save_cat_pt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import (clip_text_from_jax, gpt_from_jax,
                                     load_reference_clip_text,
                                     load_reference_gpt)
from favae_tpu_torch.models import clip_text as tclip
from favae_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=64, n_layer=2, n_embed=64, n_head=4, dim_head=16,
             n_cond_embed=32, image_encoded_dim=4, max_text_len=7, dropout=0.0)
CLIP = dict(context_length=7, vocab_size=100, width=64, heads=2, layers=2,
            embed_dim=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def gpts():
    cfg = jcfg.GPTConfig(**SMALL)
    model = jgpt.GPT(cfg, dtype=jnp.float32)
    n = cfg.image_encoded_dim ** 2
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, n - 1), jnp.int32),
                        jnp.zeros((1, 7, 32), jnp.float32),
                        jnp.ones((1, 7), bool), cond_drop_prob=0.0)["params"]
    rng = np.random.RandomState(1)   # LayerNorm scales away from their init
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(1 + 0.2 * rng.randn(*a.shape), a.dtype)
                         if "scale" in jax.tree_util.keystr(path) else a),
        params)
    ours = tgpt.GPT(tcfg.GPTConfig(**SMALL), dtype=torch.float32).eval()
    ours.load_state_dict(gpt_from_jax(_np_tree(params)), strict=True)
    return model, params, ours


def _inputs(b=3, n=15, seed=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 64, (b, n))
    embeds = rng.randn(b, 7, 32).astype(np.float32)
    mask = rng.rand(b, 7) > 0.3
    return ids, embeds, mask


@pytest.mark.parametrize("cond_drop_prob", [0.0, 1.0])
def test_gpt_eval_forward_matches_jax(gpts, cond_drop_prob):
    model, params, ours = gpts
    ids, embeds, mask = _inputs()
    ref = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(embeds),
                      jnp.asarray(mask), cond_drop_prob=cond_drop_prob)
    with torch.no_grad():
        out = ours(torch.from_numpy(ids), torch.from_numpy(embeds),
                   torch.from_numpy(mask), cond_drop_prob=cond_drop_prob)
    assert out.shape == (3, 16, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_forward_with_cond_scale_matches_jax(gpts, cond_scale):
    model, params, ours = gpts
    ids, embeds, mask = _inputs(seed=3)
    ref = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(embeds),
                      jnp.asarray(mask), cond_scale,
                      method=jgpt.GPT.forward_with_cond_scale)
    with torch.no_grad():
        out = ours.forward_with_cond_scale(
            torch.from_numpy(ids), torch.from_numpy(embeds),
            torch.from_numpy(mask), cond_scale)
    # CFG multiplies the difference of two forwards by cond_scale
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4, rtol=0)


def test_short_prefix_and_cast_weights_change_nothing(gpts):
    _, _, ours = gpts
    ids, embeds, mask = _inputs(n=5, seed=4)
    args = (torch.from_numpy(ids), torch.from_numpy(embeds),
            torch.from_numpy(mask))
    with torch.no_grad():
        a = ours(*args, cond_drop_prob=0.0)
        with ours.cast_weights():
            b = ours(*args, cond_drop_prob=0.0)
    assert a.shape == (3, 6, 64) and torch.equal(a, b)
    assert all(m.cast is None for m in ours.modules()
               if isinstance(m, tgpt.Dense))


def test_rel_pos_bias_matches_jax(gpts):
    model, params, ours = gpts
    np.testing.assert_array_equal(tgpt._rel_pos_indices(4),
                                  jgpt._rel_pos_indices(4))
    table = params["blocks"]["self_attn"]["rel_pos_bias"]["pos_bias"][
        "embedding"][0]
    bias_mod = jgpt.RelPosBias2d(4, 4)
    p = {"params": {"pos_bias": {"embedding": table}}}
    rpb = ours.blocks[0].self_attn.rel_pos_bias
    with torch.no_grad():
        np.testing.assert_allclose(
            rpb(16, 17).numpy(), np.asarray(bias_mod.apply(p, 16, 17)),
            atol=1e-7)
        for pos in (0, 5, 15):
            ref = bias_mod.apply(p, 1, 17, row_offset=pos)
            np.testing.assert_allclose(rpb(1, 17, row_offset=pos).numpy(),
                                       np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize("top_k,top_p", [(None, 1.0), (8, 1.0), (None, 0.9),
                                         (8, 0.9), (500, 0.95), (64, 0.5)])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    rng = np.random.RandomState(5)
    logits = (rng.randn(4, 64) * 3).astype(np.float32)
    logits[1, 10:20] = logits[1, 10]           # ties inside the kept set
    ref = jgpt.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p)
    out = tgpt.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_gumbel_sample_matches_jax_under_the_same_noise(temperature):
    rng = np.random.RandomState(6)
    logits = rng.randn(5, 64).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.gumbel(key, (5, 64), dtype=jnp.float32))
    ref = jgpt.gumbel_sample(jnp.asarray(logits), key, temperature)
    out = tgpt.gumbel_sample(torch.from_numpy(logits), None, temperature,
                             torch.from_numpy(noise))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gumbel_sample_draws_from_the_generator():
    logits = torch.zeros(2000, 4)
    logits[:, 0] = 2.0
    g = torch.Generator().manual_seed(0)
    a = tgpt.gumbel_sample(logits, g)
    b = tgpt.gumbel_sample(logits, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    # P(argmax = 0) = softmax(logits)[0] = e^2 / (e^2 + 3) = 0.711
    assert abs((a == 0).float().mean().item() - 0.711) < 0.04


def test_training_only_parts_raise(gpts):
    """The three calls that raised before CAT training was ported now run:
    the training forward, the default cond_drop_prob 0.25 (a random keep
    mask) and fold_ln_scale. What still raises is a random draw without
    the caller's generator: the port never draws from the global RNG."""
    _, params, ours = gpts
    ids, embeds, mask = _inputs()
    args = (torch.from_numpy(ids), torch.from_numpy(embeds),
            torch.from_numpy(mask))
    gen = torch.Generator().manual_seed(0)
    assert ours(*args, train=True, generator=gen).shape == (3, 16, 64)
    with torch.no_grad():
        assert ours(*args, generator=gen).shape == (3, 16, 64)
    folded = tgpt.GPT(tcfg.GPTConfig(**SMALL, fold_ln_scale=True),
                      dtype=torch.float32).eval()
    folded.load_state_dict(ours.state_dict(), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            folded(*args, cond_drop_prob=0.0).numpy(),
            ours(*args, cond_drop_prob=0.0).numpy(), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="Generator"):
        ours(*args, train=True)          # cfg.cond_drop_prob = 0.25, no mask
    with pytest.raises(ValueError, match="Generator"):
        ours(*args)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="unknown remat policy 'some'"):
        tgpt.GPT(tcfg.GPTConfig(**SMALL, remat="some"))


def test_reference_cat_checkpoint_loads(gpts, tmp_path):
    """A file written by favae_tpu's exporter (with the reference's dead
    cond_proj, beta, to_logits and pos_indices entries) loads into the port's
    GPT and equals the direct conversion; an unknown key still fails."""
    _, params, ours = gpts
    path = tmp_path / "cat.pt"
    save_cat_pt(str(path), _np_tree(params), image_encoded_dim=4,
                n_cond_embed=32)
    fresh = tgpt.GPT(tcfg.GPTConfig(**SMALL), dtype=torch.float32).eval()
    load_reference_gpt(fresh, str(path))
    want = ours.state_dict()
    assert set(fresh.state_dict()) == set(want)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_cat_gpt(_np_tree(params), image_encoded_dim=4,
                         n_cond_embed=32).items()}
    assert any(k.startswith("cond_proj.") for k in sd)
    sd["blocks.0.0.unknown"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="unknown"):
        load_reference_gpt(fresh, sd)


@pytest.fixture(scope="module")
def clips():
    cfg = jcfg.CLIPTextConfig(**CLIP)
    model = jclip.CLIPTextEncoder(cfg)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 7), jnp.int32))["params"]
    rng = np.random.RandomState(7)   # biases and norms away from their init
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(a + 0.1 * rng.randn(*a.shape), a.dtype)
                         if a.ndim == 1 else a), params)
    ours = tclip.CLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP)).eval()
    ours.load_state_dict(clip_text_from_jax(_np_tree(params)), strict=True)
    return model, params, ours


def test_clip_text_encoder_matches_jax(clips):
    model, params, ours = clips
    ids = np.random.RandomState(8).randint(1, 100, (3, 7))
    ids[0, 4:] = 0
    ref_seq, ref_pooled = model.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        seq, pooled = ours(torch.from_numpy(ids))
    assert seq.shape == (3, 7, 32) and pooled.shape == (3, 32)
    np.testing.assert_allclose(seq.numpy(), np.asarray(ref_seq), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               atol=1e-4, rtol=0)


def test_openai_layout_loads_with_the_vision_tower_dropped(clips):
    _, params, ours = clips
    sd = dict(clip_text_from_jax(_np_tree(params)))
    assert "transformer.resblocks.1.attn.in_proj_weight" in sd
    assert "transformer.resblocks.0.mlp.c_fc.bias" in sd
    sd["visual.conv1.weight"] = torch.zeros(4, 3, 2, 2)
    sd["logit_scale"] = torch.zeros(())
    fresh = tclip.CLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP)).eval()
    load_reference_clip_text(fresh, sd)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, ours.state_dict()[k]), k


PROMPTS = ["a smiling woman with glasses", "An OLD man's  beard, grey!",
           "café déjà vu: 3 naïve façades", "x_y & 42% off <|endoftext|>",
           "sy ssyy s y"]


@pytest.mark.parametrize("merges", [["s y"], ["s y", "sy </w>", "a n", "m an"]])
def test_tokenizer_ids_match_jax(merges):
    ref_tok = jclip.BPETokenizer(merges=merges)
    tok = tclip.BPETokenizer(merges=merges)
    ref = jclip.tokenize(ref_tok, PROMPTS, 77)
    out = tclip.tokenize(tok, PROMPTS, 77)
    assert out.dtype == np.int32 and out.shape == (5, 77)
    np.testing.assert_array_equal(out, ref)
    short = tclip.tokenize(tok, PROMPTS, 6)
    np.testing.assert_array_equal(short, jclip.tokenize(ref_tok, PROMPTS, 6))
    assert (short[:, -1] == tok.eot).all()
    assert tok.decode(tok.encode("glasses")) == "glasses "


def test_stdlib_word_pattern_splits_like_clips_own():
    """Without the `regex` package the tokenizer uses a standard-library
    pattern; on ASCII and accented Latin text the two split alike. They part
    on numerals outside class Nd, which `re` takes for letters."""
    pattern, which = tclip.word_pattern()
    assert which in ("regex", "re")
    fallback = tclip.stdlib_word_pattern()
    for text in [p.lower() for p in PROMPTS] + ["it's we're 1st 22nd"]:
        assert fallback.findall(text) == jclip.BPETokenizer.PAT.findall(text)
        assert pattern.findall(text) == jclip.BPETokenizer.PAT.findall(text)
    assert fallback.findall("a½b") == ["a½b"]
    assert jclip.BPETokenizer.PAT.findall("a½b") == ["a", "½", "b"]
