"""The port's checkpoints and resume, on the CPU.

- `utils/checkpoint.py` through the cases tests/test_data_and_trainer.py
  holds for the JAX package's: the atomic round trip, the `.old` and
  committed-`.tmp` crash windows, the cadence with the final epoch; and
  beside `favae_tpu.utils.checkpoint.CheckpointManager` on the same score
  sequences: the same directories and the same `host_meta.json`.
- Both trainers: `fit` for 2 epochs against 1 epoch, a new trainer,
  `resume()` and 1 more epoch must give bit for bit the same model,
  optimizer state and step (CAT at dropout 0.1, on the full pipeline and
  on cached latents, with f32 and bf16 moments, which needs the dropout
  generator's state in the checkpoint); a resume from an explicit
  directory; a `.pt` warm start with fresh optimizers and epoch 0; and
  previews that leave the CAT trajectory as it was.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from favae_tpu.utils import checkpoint as jckpt
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.models.clip_text import BPETokenizer
from favae_tpu_torch.train.cat_trainer import CATTrainer
from favae_tpu_torch.train.favae_trainer import FavaeTrainer
from favae_tpu_torch.utils.checkpoint import (NOT_A_PORT_CHECKPOINT,
                                              CheckpointManager,
                                              restore_checkpoint,
                                              save_checkpoint)
from tests.cat_train_common import MERGES, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_roundtrip(tmp_path):
    state = {"a": torch.arange(5.0), "b": {"c": torch.zeros(()),
                                           "n": [torch.ones(2), 3]}}
    p = str(tmp_path / "ck")
    save_checkpoint(p, state, {"epoch": 3})
    restored, meta = restore_checkpoint(p)
    assert torch.equal(restored["a"], state["a"]) and meta["epoch"] == 3
    assert restored["b"]["n"][1] == 3
    state2 = {"a": torch.ones(5), "b": {"c": torch.ones(())}}
    save_checkpoint(p, state2, {"epoch": 4})
    restored2, meta2 = restore_checkpoint(p)
    assert torch.equal(restored2["a"], state2["a"]) and meta2["epoch"] == 4
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(p)) == ["_COMMITTED", "host_meta.json",
                                     "state.pt"]


def test_checkpoint_crash_window_old_fallback(tmp_path):
    """Died after `latest` was renamed away, before the new write landed:
    `try_resume` restores latest.old (an uncommitted tmp is ignored)."""
    state = {"a": torch.arange(4.0)}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    save_checkpoint(mgr.latest_path, state, {"epoch": 5, "best_score": 0.5})
    os.rename(mgr.latest_path, mgr.latest_path + ".old")
    os.makedirs(mgr.latest_path + ".tmp")
    restored, meta = mgr.try_resume()
    assert restored is not None and meta["epoch"] == 5
    assert torch.equal(restored["a"], state["a"])
    assert mgr.best_score == 0.5


def test_checkpoint_crash_window_tmp_fallback(tmp_path):
    """Died between the two renames: a committed latest.tmp (the newer
    state) wins over latest.old, and latest exists again."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    save_checkpoint(mgr.latest_path, {"a": torch.zeros(4)}, {"epoch": 1})
    scratch = str(tmp_path / "scratch")
    save_checkpoint(scratch, {"a": torch.ones(4)}, {"epoch": 2})
    os.rename(mgr.latest_path, mgr.latest_path + ".old")
    os.rename(scratch, mgr.latest_path + ".tmp")
    restored, meta = mgr.try_resume()
    assert meta["epoch"] == 2 and torch.equal(restored["a"], torch.ones(4))
    assert os.path.isdir(mgr.latest_path)


def test_checkpoint_cadence_and_final_epoch(tmp_path):
    """save_every_epoch 4 skips off-cadence epochs (latest and best), the
    final epoch always persists; best is the best persisted epoch."""
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every_epoch=4)
    scores = [5.0, 4.0, 3.0, 2.0, 1.0, 0.5]
    for epoch, s in enumerate(scores):
        mgr.on_epoch_end(epoch, s, {"a": torch.full((3,), float(epoch))},
                         is_last=epoch == len(scores) - 1)
        if epoch in (0, 3):
            assert restore_checkpoint(mgr.latest_path)[1]["epoch"] == 1
    restored, meta = restore_checkpoint(mgr.latest_path)
    assert meta["epoch"] == len(scores)
    assert torch.equal(restored["a"], torch.full((3,), 5.0))
    assert restore_checkpoint(mgr.best_path)[1]["score"] == 0.5
    mgr2 = CheckpointManager(str(tmp_path / "ck2"))
    mgr2.on_epoch_end(0, 9.0, {"a": torch.zeros(2)})
    assert restore_checkpoint(mgr2.latest_path)[1]["epoch"] == 1
    assert mgr2.try_resume()[1]["best_score"] == 9.0


def test_restore_names_the_route_from_an_orbax_directory(tmp_path):
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(FileNotFoundError, match="favae_tpu.cli.export_torch"):
        restore_checkpoint(str(tmp_path / "orbax"))
    assert "--torch_ckpt" in NOT_A_PORT_CHECKPOINT


def _tree(root):
    out = {}
    for d in sorted(os.listdir(root)):
        with open(os.path.join(root, d, "host_meta.json")) as f:
            out[d] = (sorted(os.listdir(os.path.join(root, d))), json.load(f))
    return out


@pytest.mark.parametrize("every,scores", [
    (1, [3.0, 2.5, 2.7, 1.0]),
    (2, [3.0, 2.5, 2.7, 1.0, 4.0]),
    (1, [float("inf")] * 3),      # no val loader: best is never written
    (3, [2.0, 1.0, 3.0, 0.5]),
])
def test_manager_writes_what_the_jax_manager_writes(tmp_path, every, scores):
    """The same score sequence through both managers: the same checkpoint
    directories, the same host_meta.json in each, after every epoch."""
    ours = CheckpointManager(str(tmp_path / "port"), every)
    ref = jckpt.CheckpointManager(str(tmp_path / "jax"), every)
    for epoch, s in enumerate(scores):
        last = epoch == len(scores) - 1
        ours.on_epoch_end(epoch, s, {"a": torch.full((2,), float(epoch))},
                          is_last=last)
        ref.on_epoch_end(epoch, s, {"a": np.full((2,), float(epoch),
                                                 np.float32)}, is_last=last)
        mine, theirs = _tree(ours.save_dir), _tree(ref.save_dir)
        assert mine.keys() == theirs.keys()
        for d in mine:
            assert mine[d][1] == theirs[d][1], (epoch, d)
            assert "_COMMITTED" in mine[d][0] and "state.pt" in mine[d][0]
    assert ours.best_score == ref.best_score


# ---------------------------------------------------------------------------
# the FA-VAE trainer
# ---------------------------------------------------------------------------

def _favae_cfgs():
    model = tcfg.VQGANConfig(
        codec=tcfg.CodecConfig(base_channels=32, ch_mult=(1, 2),
                               num_res_blocks=1, attn_resolutions=(),
                               resolution=32, z_channels=64),
        quantizer=tcfg.QuantizerConfig(codebook_size=64, dim=64,
                                       use_cosine_sim=True),
        discriminator=tcfg.DiscriminatorConfig(kind="conv", num_layers=2),
        fcm_kind="res", dsl_mode="pair", compute_dtype="float32")
    losses = tcfg.LossConfig(gaussian_kernel=3, dsl_init_sigma=1.0,
                             disc_start_epochs=1, ffl_start_epochs=0,
                             dsl_weight=0.01, ffl_weight=1.0)
    return model, losses, tcfg.TrainConfig(batch_size=2, epochs=2)


def _favae_trainer(save_dir):
    m, lc, tc = _favae_cfgs()
    tr = FavaeTrainer(m, lc, tc, str(save_dir), device="cpu")
    train = DataLoader(SyntheticDataset(32, size=4, seed=1), 2,
                       num_workers=1, shuffle=True, seed=0)
    val = DataLoader(SyntheticDataset(32, size=2, seed=7), 2, num_workers=1)
    return tr, train, val


def _assert_same_tree(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("how", ["latest", "directory"])
def test_favae_resume_is_bitwise(tmp_path, how):
    """2 epochs (D from the second, so the restored stage switches on)
    against 1 epoch, a new trainer resumed from `latest` (or from the
    `best` directory by path), and the second epoch."""
    full, train, val = _favae_trainer(tmp_path / "full")
    full.fit(train, val)
    half, train, val = _favae_trainer(tmp_path / "half")
    half.fit(train, val, epochs=1)
    again, train, val = _favae_trainer(tmp_path / "half")
    again.resume(None if how == "latest"
                 else str(tmp_path / "half" / "best"))
    assert again.start_epoch == 1
    assert again.ckpt.best_score == half.val[0]["loss_recon"]
    again.fit(train, val)
    assert again.state.step == full.state.step == 4
    _assert_same_tree(again.state.state_dict(), full.state.state_dict())
    assert [h["loss_g"] for h in again.history] == \
        [h["loss_g"] for h in full.history[2:]]
    _, meta = restore_checkpoint(str(tmp_path / "half" / "latest"))
    assert meta["epoch"] == 2


def test_favae_resume_without_a_checkpoint_starts_fresh(tmp_path):
    tr, _, _ = _favae_trainer(tmp_path)
    tr.resume()
    assert tr.start_epoch == 0 and tr.state.step == 0


def test_favae_pt_warm_start(tmp_path):
    """A reference-format `.pt` loads the weights and buffers, with fresh
    Adams, step 0 and epoch 0."""
    from favae_tpu_torch.utils.torch_export import save_favae_pt
    src, train, val = _favae_trainer(tmp_path / "src")
    src.fit(train, val, epochs=1)
    save_favae_pt(str(tmp_path / "w.pt"), src.state.model.state_dict())
    tr, _, _ = _favae_trainer(tmp_path / "dst")
    tr.resume(str(tmp_path / "w.pt"))
    _assert_same_tree(tr.state.model.state_dict(),
                      src.state.model.state_dict())
    assert tr.start_epoch == 0 and tr.state.step == 0
    assert not tr.state.opt_g.state and not tr.state.opt_d.state
    assert (tr.state.opt_g.param_groups[0]["params"][0]
            is tr.state.model.encoder.conv_in.weight)


# ---------------------------------------------------------------------------
# the CAT trainer
# ---------------------------------------------------------------------------

def _cat_trainer(save_dir, cache_latents=False, moments="float32",
                 dropout=0.1):
    cfg = dataclasses.replace(tiny_cfg(tcfg, dropout=dropout), epochs=2,
                              adam_mu_dtype=moments, adam_nu_dtype=moments)
    train = DataLoader(SyntheticDataset(64, size=8, seed=1,
                                        with_captions=True), 4,
                       num_workers=1, shuffle=True, seed=0)
    val = DataLoader(SyntheticDataset(64, size=4, seed=7,
                                      with_captions=True), 4, num_workers=1)
    tr = CATTrainer(cfg, str(save_dir), len(train), 4, device="cpu",
                    tokenizer=BPETokenizer(merges=MERGES), seed=3,
                    cache_latents=cache_latents)
    return tr, train, val


@pytest.mark.parametrize("cache_latents,moments", [
    (False, "float32"), (True, "float32"), (False, "bfloat16")])
def test_cat_resume_is_bitwise(tmp_path, cache_latents, moments):
    """Dropout 0.1 and conditioning dropout draw from the trainer's
    generator: without its state in the checkpoint the resumed epoch
    draws other masks and the GPT ends elsewhere."""
    kw = dict(cache_latents=cache_latents, moments=moments)
    full, train, val = _cat_trainer(tmp_path / "full", **kw)
    full.fit(train, val, img_steps=0)
    half, train, val = _cat_trainer(tmp_path / "half", **kw)
    half.fit(train, val, epochs=1, img_steps=0)
    again, train, val = _cat_trainer(tmp_path / "half", **kw)
    again.resume()
    assert again.start_epoch == 1 and again.state.step == 2
    again.fit(train, val, img_steps=0)
    assert again.state.step == full.state.step == 4
    assert again.state.opt.mu[0].dtype == getattr(torch, moments)
    _assert_same_tree(again.state_dict(), full.state_dict())
    assert [h["loss_gpt"] for h in again.history] == \
        [h["loss_gpt"] for h in full.history[2:]]


def test_cat_resume_from_a_directory_and_warm_start(tmp_path):
    """`resume(dir)` restores the full state from that directory and its
    epoch; a reference `.pt` loads the GPT alone with a fresh AdamW."""
    from favae_tpu_torch.utils.torch_export import save_cat_pt
    src, train, val = _cat_trainer(tmp_path / "src")
    src.fit(train, val, epochs=1, img_steps=0)
    tr, _, _ = _cat_trainer(tmp_path / "dst")
    tr.resume(str(tmp_path / "src" / "best"))
    assert tr.start_epoch == 1 and tr.ckpt.best_score == src.val[0][
        "loss_gpt"]
    _assert_same_tree(tr.state_dict(), src.state_dict())
    gpt = src.cat.gpt.state_dict()
    save_cat_pt(str(tmp_path / "cat.pt"), gpt, image_encoded_dim=4,
                n_cond_embed=32)
    warm, _, _ = _cat_trainer(tmp_path / "warm")
    warm.resume(str(tmp_path / "cat.pt"))
    _assert_same_tree(warm.cat.gpt.state_dict(), gpt)
    assert warm.start_epoch == 0 and warm.state.opt.count == 0
    assert all(not m.any() for m in warm.state.opt.mu)


def test_cat_previews_leave_the_trajectory(tmp_path):
    """Previews at every step and after validation sample from their own
    generator: the GPT, the AdamW state and the dropout generator end as
    without them."""
    calls = []
    plain, train, val = _cat_trainer(tmp_path / "a")
    plain.fit(train, val, epochs=1, img_steps=0)
    shown, train, val = _cat_trainer(tmp_path / "b")
    grid = shown.writer.caption_grid
    shown.writer.caption_grid = lambda *a: calls.append(a) or grid(*a)
    shown.fit(train, val, epochs=1, img_steps=1)
    assert [(c[0], c[4]) for c in calls] == [
        ("train/from-cond", 0), ("train/from-cond", 1),
        ("val/from-cond", 0)]
    assert calls[0][2].shape == (4, 64, 64, 3)
    _assert_same_tree(shown.state_dict(), plain.state_dict())


# ---------------------------------------------------------------------------
# an empty validation set
# ---------------------------------------------------------------------------

def _jax_fit_with_empty_val(trainer, val_ds):
    """`fit` of a JAX trainer for one epoch with no train batch (nothing
    to compile) and a val loader of no batch; its MetricWriter's val rows
    are counted."""
    from favae_tpu.data.pipeline import DataLoader as JaxLoader
    from favae_tpu.data.pipeline import SyntheticDataset as JaxSynthetic
    rows = []
    scalars = trainer.writer.scalars
    trainer.writer.scalars = lambda tag, *a: (rows.append(tag)
                                              or scalars(tag, *a))
    train = JaxLoader(JaxSynthetic(32, size=0), batch_size=8, num_workers=1)
    val = JaxLoader(val_ds, batch_size=8, shuffle=False, num_workers=1)
    assert len(val) == 0
    trainer.fit(train, val, epochs=1)
    return rows


@pytest.mark.parametrize("trainer", ["favae", "cat"])
def test_val_set_smaller_than_a_batch_scores_inf(tmp_path, trainer):
    """A val file with fewer images than one batch validates nothing: the
    epoch's score is inf, there is no val row and no `best`, as in the JAX
    package (its `fit` tests `if val_loader`, and the loader's length is
    0); `latest` is written with best_score inf."""
    if trainer == "favae":
        tr, train, _ = _favae_trainer(tmp_path / "port")
        val = DataLoader(SyntheticDataset(32, size=1, seed=7), 2,
                         num_workers=1)
        tr.fit(train, val, epochs=1)
    else:
        tr, train, _ = _cat_trainer(tmp_path / "port")
        val = DataLoader(SyntheticDataset(64, size=3, seed=7,
                                          with_captions=True), 4,
                         num_workers=1)
        tr.fit(train, val, epochs=1, img_steps=0)
    assert len(val) == 0 and tr.val == [] and len(tr.history) == 2
    assert tr.ckpt.best_score == float("inf")
    assert not (tmp_path / "port" / "best").exists()
    _, meta = restore_checkpoint(str(tmp_path / "port" / "latest"))
    assert meta["epoch"] == 1 and meta["best_score"] == float("inf")
    if trainer == "favae":  # the JAX package's trainer, the same way
        from favae_tpu.data.pipeline import SyntheticDataset as JaxSynthetic
        from tests.test_data_and_trainer import tiny_setup
        jtr = tiny_setup(tmp_path, "jax")
        rows = _jax_fit_with_empty_val(jtr, JaxSynthetic(32, size=4))
        assert "val" not in rows and jtr.ckpt.best_score == float("inf")
        assert not (tmp_path / "jax" / "best").exists()
        assert (tmp_path / "jax" / "latest").exists()
