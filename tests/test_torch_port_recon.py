"""favae_tpu_torch reconstruction (encode -> VQ -> decode) against the JAX
package, weight loading, and the port's eval CLI, on the CPU.

The JAX side is `VQGANFCM.encode` -> `VQGANFCM.decode` as
favae_tpu/cli/eval_favae.py runs it, in f32 at "highest" matmul precision;
the port runs in f32 with TF32 off. Indices must be equal (the test first
checks that no token's top-2 score margin is under 1e-4, so no near-tie can
flip), and the reconstruction must match to atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.data.pipeline import SyntheticDataset as JaxSynthetic
from favae_tpu.models.quantizer import init_codebook_state, l2norm
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu.utils.torch_export import save_favae_pt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import eval_favae
from favae_tpu_torch.convert import from_jax_params, load_reference_checkpoint
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.models.vqgan import VQGANFCM
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY_CODEC = dict(base_channels=64, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), resolution=16, z_channels=32)


@pytest.fixture(autouse=True)
def _f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg(m, fcm_kind, dsl_mode, **quantizer):
    q = dict(codebook_size=64, dim=32, use_cosine_sim=True)
    q.update(quantizer)
    return m.VQGANConfig(codec=m.CodecConfig(**TINY_CODEC),
                         quantizer=m.QuantizerConfig(**q),
                         fcm_kind=fcm_kind, dsl_mode=dsl_mode,
                         compute_dtype="float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(cfg, seed):
    model = JaxVQGAN(cfg)
    key = jax.random.PRNGKey(seed)
    cb = init_codebook_state(cfg.quantizer, key)
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((1, 16, 16, 3), jnp.float32), cb,
                           train=False)
    return (model, _np_tree(variables["params"]), cb,
            _np_tree(variables.get("batch_stats", {})))


def _jax_recon(model, params, cb, x):
    v = {"params": params}
    z_q, _, idx, _, _ = model.apply(v, jnp.asarray(x), cb, train=False,
                                    inference=True, method=JaxVQGAN.encode)
    x_rec, _, _ = model.apply(v, z_q, train=False, inference=True,
                              method=JaxVQGAN.decode)
    return np.asarray(x_rec), np.asarray(idx)


def _min_margin(model, params, cb, cfg, x):
    """Smallest top-2 gap of the codebook scores over all tokens (f64)."""
    z, _ = model.apply({"params": params}, jnp.asarray(x),
                       method=lambda m, x: m.encoder(x, train=False,
                                                     inference=True))
    flat = jnp.asarray(z, jnp.float32).reshape(-1, z.shape[-1])
    if "project_in" in params.get("quantizer", {}):
        p = params["quantizer"]["project_in"]
        flat = flat @ p["kernel"] + p["bias"]
    e = cb.embed
    if cfg.quantizer.use_cosine_sim:
        flat, e = l2norm(flat), l2norm(e)
        scores = np.asarray(flat, np.float64) @ np.asarray(e, np.float64).T
    else:
        d = np.asarray(flat, np.float64)[:, None] - np.asarray(e, np.float64)
        scores = -np.sum(d * d, axis=-1)
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return float(np.min(top2[:, 1] - top2[:, 0]))


@pytest.mark.parametrize("fcm_kind,dsl_mode,quantizer", [
    ("res", "nonpair", {}),                           # expe5's topology
    ("conv", "pair", {"use_cosine_sim": False}),      # euclidean codebook
    ("conv", "pair", {"codebook_dim": 16}),           # projected codebook
])
def test_reconstruct_matches_jax(fcm_kind, dsl_mode, quantizer):
    jc = _cfg(jcfg, fcm_kind, dsl_mode, **quantizer)
    tc = _cfg(tcfg, fcm_kind, dsl_mode, **quantizer)
    jmodel, params, cb, _ = _jax_model(jc, seed=5)
    x = (np.random.RandomState(6).rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    assert _min_margin(jmodel, params, cb, jc, x) > 1e-4
    ref_rec, ref_idx = _jax_recon(jmodel, params, cb, x)

    tmodel = VQGANFCM(tc).eval()
    tmodel.load_state_dict(from_jax_params(params, _np_tree(cb), tc),
                           strict=True)
    rec, idx = tmodel.reconstruct(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(rec.numpy(), ref_rec, atol=1e-3, rtol=0)

    # the token grid decodes to the same image
    np.testing.assert_allclose(tmodel.decode_code(idx).numpy(), ref_rec,
                               atol=1e-3, rtol=0)


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A reference-format .pt from favae_tpu's exporter loads with a strict
    load_state_dict (discriminator dropped) and gives the same recon."""
    jc = _cfg(jcfg, "res", "nonpair")
    tc = _cfg(tcfg, "res", "nonpair")
    jmodel, params, cb, batch_stats = _jax_model(jc, seed=5)
    path = tmp_path / "favae.pt"
    save_favae_pt(str(path), params, batch_stats, cb, jc)

    tmodel = VQGANFCM(tc).eval()
    load_reference_checkpoint(tmodel, str(path))
    x = (np.random.RandomState(6).rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    ref_rec, ref_idx = _jax_recon(jmodel, params, cb, x)
    rec, idx = tmodel.reconstruct(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(rec.numpy(), ref_rec, atol=1e-3, rtol=0)


def test_synthetic_data_matches_jax_pipeline():
    ours = SyntheticDataset(resolution=8, size=5, seed=2)
    ref = JaxSynthetic(resolution=8, size=5, seed=2)
    for i in range(7):
        np.testing.assert_array_equal(ours.get(i), ref.get(i))
    batches = list(DataLoader(ours, batch_size=2, num_workers=2))
    assert len(batches) == 2 and batches[1].shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(batches[1][0], ref.get(2))


def test_eval_cli_on_cpu():
    """The expe5 preset at full width on 16 px images, on the CPU."""
    m = eval_favae.main(["--preset", "celebahq_expe5", "--synthetic_data",
                         "--batch_size", "2", "--max_images", "4",
                         "--resolution", "16", "--num_workers", "1",
                         "--device", "cpu"])
    assert m["images"] == 4 and len(m["batch_ms"]) == 2
    assert np.isfinite(m["psnr"]) and np.isfinite(m["l1"])
    assert 0.0 < m["codebook_usage"] <= 4 / 1024


@pytest.mark.parametrize("flag", ["--orbax_ckpt"])
def test_eval_cli_names_what_is_not_ported(flag, tmp_path):
    """A favae_tpu Orbax directory (no `state.pt`) does not load; the
    message names the route through the JAX package's exporter."""
    (tmp_path / "best").mkdir()
    with pytest.raises(FileNotFoundError,
                       match="favae_tpu.cli.export_torch.*--torch_ckpt"):
        eval_favae.main(["--device", "cpu", "--resolution", "16",
                         flag, str(tmp_path / "best")])
