"""The port's FA-VAE eval step against `favae_tpu.train.favae_step`, its
loader's shuffle, and the port's train and eval CLIs' guards, on the CPU.

The train-step cases are in tests/test_torch_port_train_gate_d_ffl.py and
tests/test_torch_port_train_gate_d_off.py, the train CLI's run in
tests/test_torch_port_train_cli.py; all start from
tests/favae_train_common.py's state.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu.train.favae_step import make_eval_step as jax_eval_step
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import eval_favae, train_favae
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.models.lpips import LPIPS
from favae_tpu_torch.train.favae_step import make_eval_step
from tests.favae_train_common import (batch, cfgs, f32_torch,  # noqa: F401
                                      start)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_eval_step_matches_jax():
    jstate, tstate, _, _, _ = start()
    jm, jl, _ = cfgs(jcfg)
    ev = jax.jit(jax_eval_step(JaxVQGAN(jm, gaussian_kernel=3,
                                        dsl_init_sigma=1.0),
                               JaxLPIPS(dtype=jnp.float32), jl))
    x = batch(3)
    ref = ev(jstate, jnp.asarray(x))
    ours = make_eval_step(cfgs(tcfg)[1])(tstate, torch.from_numpy(x))
    for k in ("loss_l1", "loss_perceptual", "loss_recon"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4)
    np.testing.assert_array_equal(ours["indices"].numpy(),
                                  np.asarray(ref["indices"]))


def test_loader_shuffles_like_jax():
    from favae_tpu.data.pipeline import DataLoader as JaxLoader
    ds = SyntheticDataset(resolution=2, size=10)
    ours = DataLoader(ds, batch_size=3, num_workers=1, shuffle=True, seed=4)
    ref = JaxLoader(ds, batch_size=3, shuffle=True, seed=4, num_workers=1)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(ours)
        want = list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(list(ours)[0], list(DataLoader(
        ds, batch_size=3, num_workers=1))[0])


@pytest.mark.parametrize("flag", [
    ["--kmeans_init", "--threshold_ema_dead_code", "1.0",
     "--orthogonal_reg_weight", "1.0", "--orthogonal_reg_max_codes", "8",
     "--use_patch_discriminator", "--use_actnorm"],
    ["--adam_mu_dtype", "bfloat16", "--orthogonal_reg_weight", "1.0",
     "--orthogonal_reg_active_codes_only"]])
def test_train_cli_names_what_is_not_ported(flag, tmp_path):
    """The train options that raised before they were ported run through
    the CLI on the CPU: a small flag-built model (128 tokens a batch, 16
    codes), one epoch of 2 steps with the discriminator, and validation.
    The run's checkpoints (~0.6 GB each) are removed after it."""
    out_dir = tmp_path / "out"
    out = train_favae.main([
        "--ds", "x", "--output_dir", str(out_dir), "--device", "cpu",
        "--downsample_factor", "4", "--resolution", "32", "--embed_dim", "8",
        "--codebook_size", "16", "--num_groups", "8", "--use_cosine_sim",
        "--kmeans_iters", "2", "--disc_n_layers", "2", "--synthetic_data",
        "--synthetic_steps", "2",
        "--batch_size", "2", "--epochs", "1", "--disc_start_epochs", "0",
        "--num_workers", "1", "--compute_dtype", "float32", *flag])
    shutil.rmtree(out_dir)
    assert len(out["history"]) == 2 and len(out["val"]) == 1
    assert all(np.isfinite(h["loss_g"]) and np.isfinite(h["loss_d"])
               for h in out["history"])
    if "--threshold_ema_dead_code" in flag:
        assert "cb_replaced" in out["history"][0]


def test_train_cli_runs_on_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_favae.main(["--ds", "x", "--output_dir", str(tmp_path),
                          "--preset", "celebahq_expe5", "--synthetic_data"])


def test_eval_cli_lpips_ckpt(tmp_path):
    """--lpips_ckpt loads a reference-layout LPIPS state_dict (one the test
    writes, with the scaling layer's buffers the reference file carries) and
    reports `lpips`, the mean per-image distance."""
    lp = LPIPS(torch.float32)
    # the trained heads are non-negative, so the distance is
    sd = {k: v.abs() if k.startswith("lin") else v
          for k, v in lp.state_dict().items()}
    sd["scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    sd["scaling_layer.scale"] = torch.ones(1, 3, 1, 1)
    path = tmp_path / "vgg16_lpips.pt"
    torch.save(sd, path)
    m = eval_favae.main(["--preset", "celebahq_expe5", "--synthetic_data",
                         "--batch_size", "2", "--max_images", "2",
                         "--resolution", "16", "--num_workers", "1",
                         "--device", "cpu", "--lpips_ckpt", str(path)])
    assert np.isfinite(m["lpips"]) and m["lpips"] > 0.0

