"""The port's reference-format export against favae_tpu.utils.torch_export,
and the slice as a whole, on the CPU.

- `save_favae_pt` / `save_cat_pt` of the port and of the JAX package, on
  the same weights (the JAX package's, carried in by `from_jax_params` /
  `gpt_from_jax`): files with equal keys, dtypes and values, the GPT's
  dead entries included (the BatchNorm counters are 0-dim in the port's
  file, as torch writes them, and (1,) in the JAX package's).
- The port's files through the JAX package's own loaders
  (`convert_favae`, `convert_cat_gpt`): the JAX models reproduce their
  outputs within atol 1e-5.
- `cli.train_favae` for 2 epochs at a tiny configuration (given the
  preset's name in both packages) -> `cli.export_torch` of `best` -> the
  port's `eval_favae` and the JAX package's `eval_favae` on that `.pt`:
  the same `psnr`, `l1` and `codebook_usage` within 1e-4 relative; and the
  port's eval on the checkpoint directory (`--orbax_ckpt`) equals its
  eval on the exported file.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import gpt as jgpt
from favae_tpu.models.quantizer import init_codebook_state
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu.utils import torch_convert as jconv
from favae_tpu.utils import torch_export as jexp
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import eval_favae, export_torch, train_favae
from favae_tpu_torch.convert import from_jax_params, gpt_from_jax
from favae_tpu_torch.models.vqgan import VQGANFCM
from favae_tpu_torch.utils import torch_export as texp
from tests.cat_train_common import np_tree, port_gpt, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY_CODEC = dict(base_channels=32, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), resolution=16, z_channels=32)


def _favae_cfg(m, fcm_kind, dsl_mode, disc, compute_dtype="float32",
               **quantizer):
    q = dict(codebook_size=64, dim=32, use_cosine_sim=True)
    q.update(quantizer)
    return m.VQGANConfig(codec=m.CodecConfig(**TINY_CODEC),
                         quantizer=m.QuantizerConfig(**q),
                         discriminator=m.DiscriminatorConfig(
                             kind=disc, num_layers=2),
                         fcm_kind=fcm_kind, dsl_mode=dsl_mode,
                         compute_dtype=compute_dtype)


def _same_files(ours_path, ref_path, key):
    ours = torch.load(ours_path, weights_only=True)
    ref = torch.load(ref_path, weights_only=True)
    assert set(ours) == set(ref)
    a, b = ours[key], ref[key]
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        ak, bk = a[k], b[k]
        if k.endswith("num_batches_tracked"):
            # torch's BatchNorm keeps a 0-dim counter (the port writes it
            # so); the JAX exporter's np.ascontiguousarray makes it (1,),
            # which torch's load_state_dict also takes
            assert ak.shape == () and bk.shape == (1,), k
            bk = bk.reshape(())
        assert ak.dtype == bk.dtype and ak.shape == bk.shape, k
        assert torch.equal(ak, bk), k
    return ours


def _jax_recon(model, variables, cb, x):
    z_q, _, idx, _, _ = model.apply(variables, jnp.asarray(x), cb,
                                    train=False, inference=True,
                                    method=JaxVQGAN.encode)
    rec, _, _ = model.apply(variables, z_q, train=False, inference=True,
                            method=JaxVQGAN.decode)
    return np.asarray(rec), np.asarray(idx)


@pytest.mark.parametrize("fcm_kind,dsl_mode,disc,quantizer", [
    ("res", "nonpair", "conv", {}),
    ("conv", "pair", "patch", {"use_cosine_sim": False}),
    ("conv", "pair", "conv", {"codebook_dim": 16}),
])
def test_favae_export_matches_jax(tmp_path, fcm_kind, dsl_mode, disc,
                                  quantizer):
    jc = _favae_cfg(jcfg, fcm_kind, dsl_mode, disc, **quantizer)
    tc = _favae_cfg(tcfg, fcm_kind, dsl_mode, disc, **quantizer)
    model = JaxVQGAN(jc)
    key = jax.random.PRNGKey(4)
    cb = np_tree(init_codebook_state(jc.quantizer, key))
    variables = np_tree(model.init({"params": key, "dropout": key},
                                   jnp.zeros((1, 16, 16, 3)), cb,
                                   train=False))
    params, stats = variables["params"], variables.get("batch_stats", {})
    ours = VQGANFCM(tc)
    ours.load_state_dict(from_jax_params(params, cb, tc, stats), strict=True)
    texp.save_favae_pt(str(tmp_path / "port.pt"), ours.state_dict(),
                       epoch=3, step=7)
    jexp.save_favae_pt(str(tmp_path / "jax.pt"), params, stats, cb, jc,
                       epoch=3, step=7)
    out = _same_files(tmp_path / "port.pt", tmp_path / "jax.pt", "model")
    assert (out["epoch"], out["step"]) == (3, 7)

    # the JAX package's loader takes the port's file back
    p2, s2, cb2 = jconv.convert_favae(str(tmp_path / "port.pt"), jc)
    x = (np.random.RandomState(5).rand(2, 16, 16, 3) * 2 - 1).astype(
        np.float32)
    v1 = {"params": params, **({"batch_stats": stats} if stats else {})}
    v2 = {"params": p2, **({"batch_stats": s2} if s2 else {})}
    rec, idx = _jax_recon(model, v1, cb, x)
    rec2, idx2 = _jax_recon(model, v2, jax.tree_util.tree_map(
        jnp.asarray, cb2), x)
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_allclose(rec2, rec, atol=1e-5, rtol=0)


def test_cat_export_matches_jax(tmp_path):
    jc, tc = tiny_cfg(jcfg), tiny_cfg(tcfg)
    gpt = jgpt.GPT(jc.gpt, dtype=jnp.float32)
    ctx = jc.gpt.max_text_len
    n = jc.gpt.image_encoded_dim ** 2
    ids = jnp.asarray(np.random.RandomState(1).randint(0, 64, (2, n - 1)))
    ctx_x = jnp.asarray(np.random.RandomState(2).randn(
        2, ctx, jc.gpt.n_cond_embed).astype(np.float32))
    mask = jnp.ones((2, ctx), bool)
    params = jax.jit(lambda k: gpt.init(k, ids, ctx_x, mask,
                                        cond_drop_prob=0.0))(
        jax.random.PRNGKey(6))["params"]
    ours = port_gpt(tc, params)
    kw = dict(image_encoded_dim=jc.gpt.image_encoded_dim,
              n_cond_embed=jc.gpt.n_cond_embed)
    texp.save_cat_pt(str(tmp_path / "port.pt"), ours.state_dict(), epoch=2,
                     best_score=1.5, step=9, **kw)
    jexp.save_cat_pt(str(tmp_path / "jax.pt"), np_tree(params), epoch=2,
                     best_score=1.5, step=9, **kw)
    out = _same_files(tmp_path / "port.pt", tmp_path / "jax.pt",
                      "transformer_model")
    sd = out["transformer_model"]
    assert "to_logits.weight" in sd and "cond_proj.bias" in sd
    assert any(k.endswith(".pos_indices") for k in sd)
    assert (out["epoch"], out["best_score"], out["step"]) == (2, 1.5, 9)

    back = jconv.convert_cat_gpt(str(tmp_path / "port.pt"),
                                 n_layer=jc.gpt.n_layer)
    fwd = jax.jit(lambda p: gpt.apply({"params": p}, ids, ctx_x, mask,
                                      cond_drop_prob=0.0))
    np.testing.assert_allclose(np.asarray(fwd(back)), np.asarray(fwd(params)),
                               atol=1e-5, rtol=0)
    # and the port's own loader takes it strictly
    again = port_gpt(tc, params)
    torch.nn.init.zeros_(again.tok_emb.weight)
    from favae_tpu_torch.convert import load_reference_gpt
    load_reference_gpt(again, str(tmp_path / "port.pt"))
    assert torch.equal(again.tok_emb.weight, ours.tok_emb.weight)
    assert set(gpt_from_jax(np_tree(params))) == set(ours.state_dict())


def _tiny_preset(m):
    """The train tests' tiny FA-VAE in f32, standing in for a preset."""
    return m.VQGANConfig(
        codec=m.CodecConfig(base_channels=32, ch_mult=(1, 2),
                            num_res_blocks=1, attn_resolutions=(),
                            resolution=32, z_channels=64),
        quantizer=m.QuantizerConfig(codebook_size=64, dim=64,
                                    use_cosine_sim=True),
        discriminator=m.DiscriminatorConfig(kind="conv", num_layers=2),
        fcm_kind="res", dsl_mode="nonpair", compute_dtype="float32")


def test_train_export_evaluate_matches_jax(tmp_path, monkeypatch):
    from favae_tpu.cli import eval_favae as jeval
    monkeypatch.setitem(tcfg.PRESETS, "celebahq_expe5",
                        lambda: _tiny_preset(tcfg))
    monkeypatch.setitem(jcfg.PRESETS, "celebahq_expe5",
                        lambda: _tiny_preset(jcfg))
    monkeypatch.setenv("FAVAE_XLA_CACHE", str(tmp_path / "xla"))
    out = train_favae.main([
        "--ds", "slice", "--output_dir", str(tmp_path), "--device", "cpu",
        "--preset", "celebahq_expe5", "--synthetic_data",
        "--synthetic_steps", "2", "--batch_size", "2", "--epochs", "2",
        "--disc_start_epochs", "1", "--num_workers", "1"])
    assert len(out["history"]) == 4
    ckpt = tmp_path / "slice" / "best"
    pt = str(tmp_path / "best.pt")
    export_torch.main(["--orbax_ckpt", str(ckpt), "--out", pt])
    saved = torch.load(pt, weights_only=True)
    assert saved["epoch"] == 2 and saved["step"] == 4
    common = ["--preset", "celebahq_expe5", "--synthetic_data",
              "--batch_size", "4", "--max_images", "8", "--resolution",
              "32", "--num_workers", "1"]
    ours = eval_favae.main(common + ["--device", "cpu", "--torch_ckpt", pt])
    ref = jeval.main(common + ["--torch_ckpt", pt])
    for k in ("psnr", "l1", "codebook_usage"):
        assert abs(ours[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, ours, ref)
    assert ours["images"] == ref["images"] == 8
    direct = eval_favae.main(common + ["--device", "cpu", "--orbax_ckpt",
                                       str(ckpt)])
    assert {k: direct[k] for k in ("psnr", "l1", "codebook_usage")} == \
        {k: ours[k] for k in ("psnr", "l1", "codebook_usage")}


def test_export_cli_checks_the_layout_and_names_the_orbax_route(tmp_path):
    from favae_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = _tiny_preset(tcfg)
    model = VQGANFCM(cfg)
    save_checkpoint(str(tmp_path / "ck"), {"model": model.state_dict(),
                                           "step": 0}, {"epoch": 1})
    with pytest.raises(RuntimeError, match="size mismatch|Missing|Unexpected"):
        export_torch.main(["--orbax_ckpt", str(tmp_path / "ck"), "--out",
                           str(tmp_path / "x.pt")])  # expe5's layout
    export_torch.main(["--orbax_ckpt", str(tmp_path / "ck"), "--out",
                       str(tmp_path / "x.pt")], cfg=cfg)
    assert torch.load(tmp_path / "x.pt", weights_only=True)["epoch"] == 1
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="favae_tpu.cli.export_torch"):
        export_torch.main(["--orbax_ckpt", str(tmp_path / "orbax"), "--out",
                           str(tmp_path / "y.pt"), "--cat"])


def test_generate_ckpt_reads_a_cat_checkpoint_directory(tmp_path):
    """`generate --ckpt` on a train_cat checkpoint directory samples what
    `--torch_cat_ckpt` on its export samples."""
    from favae_tpu_torch.cli import generate
    from favae_tpu_torch.utils.checkpoint import save_checkpoint
    from tests.cat_train_common import port_cat
    cat, cfg = port_cat(seed=2)
    sd = cat.gpt.state_dict()
    save_checkpoint(str(tmp_path / "best"), {"gpt": sd, "step": 3},
                    {"epoch": 1, "best_score": 2.0})
    export_torch.main(["--cat", "--orbax_ckpt", str(tmp_path / "best"),
                       "--out", str(tmp_path / "cat.pt")], cfg=cfg.gpt)
    common = ["--prompt", "a face", "--n", "2", "--device", "cpu",
              "--seed", "1", "--top_k", "8"]
    a = generate.main(common + ["--ckpt", str(tmp_path / "best"), "--out",
                                str(tmp_path / "a.npz")], cfg=cfg)
    b = generate.main(common + ["--torch_cat_ckpt", str(tmp_path / "cat.pt"),
                                "--out", str(tmp_path / "b.npz")], cfg=cfg)
    c = generate.main(common + ["--out", str(tmp_path / "c.npz")], cfg=cfg)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    with pytest.raises(FileNotFoundError, match="--torch_cat_ckpt"):
        generate.main(common + ["--ckpt", str(tmp_path)], cfg=cfg)
