"""The port's FA-VAE train CLI on the CPU: a small flag-built model for two
epochs, with validation and a checkpoint after each, then resumed."""

import numpy as np

from favae_tpu_torch.cli import train_favae
from favae_tpu_torch.utils.checkpoint import restore_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_train_cli_on_cpu(tmp_path):
    """A small flag-built FCM(Res) + non-pairwise DSL model for two epochs
    (the discriminator from the second), 2 steps each, plus validation;
    then `--resume` for a third epoch at `--save_every_epoch 2`, which
    still saves the last epoch."""
    args = [
        "--ds", "smoke", "--output_dir", str(tmp_path), "--device", "cpu",
        "--use_gauss_resblock", "--downsample_factor", "4",
        "--resolution", "32", "--embed_dim", "32", "--codebook_size", "64",
        "--gaussian_kernel", "3",
        "--use_cosine_sim", "--ffl_weight", "1.0",
        "--DSL_weight_features", "0.01", "--disc_n_layers", "2",
        "--synthetic_data", "--synthetic_steps", "2", "--batch_size", "2",
        "--epochs", "2", "--disc_start_epochs", "1", "--num_workers", "1",
        "--compute_dtype", "float32", "--print_steps", "1"]
    out = train_favae.main(args)
    hist = out["history"]
    assert [(h["epoch"], h["disc_on"]) for h in hist] == [
        (0, False), (0, False), (1, True), (1, True)]
    for h in hist:
        for k in ("loss_g", "loss_l1", "loss_q", "loss_ffl",
                  "loss_dsl_features", "step_ms"):
            assert np.isfinite(h[k]), (k, h)
    assert hist[0]["weight_d"] == 0.0 and hist[-1]["loss_d"] > 0.0
    assert [v["images"] for v in out["val"]] == [8, 8]
    assert (tmp_path / "smoke" / "train_cfg.json").exists()
    _, meta = restore_checkpoint(str(tmp_path / "smoke" / "latest"))
    assert meta["epoch"] == 2 and meta["best_score"] == min(
        v["loss_recon"] for v in out["val"])
    assert (tmp_path / "smoke" / "best" / "state.pt").exists()
    again = train_favae.main(args + ["--epochs", "3", "--resume",
                                     "--save_every_epoch", "2"])
    assert again["start_epoch"] == 2
    assert [h["epoch"] for h in again["history"]] == [2, 2]
    state, meta = restore_checkpoint(str(tmp_path / "smoke" / "latest"))
    assert meta["epoch"] == 3 and state["step"] == 6
