"""The port's CAT training over a (dp, tp) grid of gloo ranks on the CPU,
against the JAX package's single-device step on the global batch.

- One step on 4 ranks, dp 2 x tp 2 (a 2-layer GPT with 4 heads split 2 a
  rank, dropout 0, JAX's conditioning keep mask handed over, each dp
  group on its half of the global batch of 4), against
  `favae_tpu.train.cat_step.make_cat_train_step` on the whole batch from
  one state, with `fold_ln_scale` off and on: the loss within 1e-4
  relative and the gathered parameters within 2.1 lr at most and 1e-3 lr
  on average (slice 4's bounds: Adam's first step moves a parameter by
  about lr * sign(g)).
- The trainer's lr at world 4 (base_lr * batch_size * world, batch_size a
  rank's share) and its schedule equal the JAX trainer's on its 8-device
  mesh at the same global batch, 1e-7 relative.
- `cli.train_cat --tp 2` on 2 ranks resumes a tp=1 checkpoint, trains an
  epoch with previews sampled through the split blocks and saves; the
  file, resumed at tp=1, equals the gathered state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models import gpt as jgpt
from favae_tpu.train.cat_step import (create_cat_state, make_cat_optimizer,
                                      make_cat_train_step)
from favae_tpu.train.cat_trainer import CATTrainer as JaxCATTrainer
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import train_cat
from favae_tpu_torch.convert import gpt_from_jax
from favae_tpu_torch.train.cat_trainer import CATTrainer
from favae_tpu_torch.utils.checkpoint import restore_checkpoint
from tests.cat_train_common import (MERGES, batch, both_cats, jax_keep,
                                    np_tree, port_cat, tiny_cfg)
from tests.torch_dist_worker import launch
from tests.torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3


def _np_sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("fold", [False, True])
def test_dp2_tp2_step_matches_jax(tmp_path, fold):
    jmodel, params, ours, tc = both_cats()
    jc = tiny_cfg(jcfg)
    if fold:
        jc = dataclasses.replace(jc, gpt=dataclasses.replace(
            jc.gpt, fold_ln_scale=True))
        tc = dataclasses.replace(tc, gpt=dataclasses.replace(
            tc.gpt, fold_ln_scale=True))
        jmodel = dataclasses.replace(
            jmodel, cfg=jc, gpt=jgpt.GPT(jc.gpt, dtype=jnp.float32))
    x, ids = batch(seed=20)
    rng = jax.random.PRNGKey(5)
    keep = jax_keep(rng, 0, 4).numpy()
    inputs = dict(cfg=tc, lr=LR, tp=2, merges=MERGES, x=x, ids=ids,
                  keep=keep, favae=_np_sd(ours.favae), clip=_np_sd(ours.clip),
                  gpt={k: v.numpy() for k, v in
                       gpt_from_jax(np_tree(params)).items()},
                  batch_size=2, save_dir=str(tmp_path / "trainer"))
    ranks = launch("cat_step", inputs, 4, tmp_path)

    tx = make_cat_optimizer(jc, optax.constant_schedule(LR))
    jstate = create_cat_state(jmodel, params, tx)
    jstate, jm = jax.jit(make_cat_train_step(jmodel, tx))(
        jstate, jmodel.frozen_params(), jnp.asarray(x), jnp.asarray(ids), rng)
    ref_loss = float(jm["loss_gpt"])
    want = gpt_from_jax(np_tree(jstate.gpt_params))
    for r in ranks:
        assert abs(r["loss"] - ref_loss) <= 1e-4 * ref_loss, (r["loss"],
                                                              ref_loss)
    errs = np.concatenate([np.abs(ranks[0]["gpt"][n] - want[n].numpy())
                           .ravel() / LR for n in want])
    assert errs.max() <= 2.1, errs.max()
    assert errs.mean() <= 1e-3, errs.mean()
    for r in ranks[1:]:  # every rank gathers the same GPT
        for n in want:
            np.testing.assert_array_equal(r["gpt"][n], ranks[0]["gpt"][n])

    if not fold:  # lr and schedule at world 4 against the JAX trainer's
        jtr = JaxCATTrainer(jc, str(tmp_path / "jax"), steps_per_epoch=10,
                            batch_size=8 // jax.device_count(),
                            favae_variables=jmodel.favae_variables,
                            cb_state=jmodel.cb_state,
                            clip_params=jmodel.clip_params,
                            tokenizer=jmodel.tokenizer)
        for r in ranks:
            assert r["lr"] == pytest.approx(jc.base_lr * 8, rel=1e-12)
            for i, v in enumerate(r["schedule"]):
                want_lr = float(jtr.lr_schedule(jnp.int32(i)))
                assert abs(v - want_lr) <= 1e-7 * max(abs(want_lr), 1e-30), i


def _cli_args(tmp_path, *extra):
    return ["--ds", "tp", "--device", "cpu", "--output_dir", str(tmp_path),
            "--synthetic_data", "--synthetic_steps", "2", "--batch_size", "1",
            "--num_workers", "1", "--print_steps", "1", "--img_steps", "1",
            "--enabled_warmup", "--warmup_epochs", "1", *extra]


def test_tp2_cli_resumes_and_saves_for_tp1(tmp_path):
    """tp=1 epoch -> 2 ranks at --tp 2 resume it and run the second epoch
    (dropout 0.1, previews through the split blocks) -> the saved file
    resumed at tp=1 equals the ranks' gathered state bit for bit."""
    cfg = tiny_cfg(tcfg, dropout=0.1)
    out1 = train_cat.main(_cli_args(tmp_path), cfg=cfg)
    assert out1["start_epoch"] == 0
    cfg = dataclasses.replace(cfg, epochs=2)  # the config passed rules
    ranks = launch("cat_cli", dict(cfg=cfg, argv=_cli_args(
        tmp_path, "--resume", "--tp", "2")), 2, tmp_path)
    for r in ranks:
        assert [h["epoch"] for h in r["history"]] == [1, 1]
        assert all(np.isfinite(h["loss_gpt"]) for h in r["history"])
        assert r["lr"] == pytest.approx(cfg.base_lr * 2, rel=1e-12)
    losses = [[h["loss_gpt"] for h in r["history"]] for r in ranks]
    assert losses[0] == losses[1]  # a tp group computes one loss
    saved, meta = restore_checkpoint(str(tmp_path / "cat" / "tp" / "latest"))
    assert meta["epoch"] == 2 and saved["step"] == 4 == ranks[0]["step"]

    ours, _ = port_cat()
    tr = CATTrainer(cfg, str(tmp_path / "cat" / "tp"), steps_per_epoch=2,
                    batch_size=1, device="cpu", cat=ours)
    tr.resume()
    assert tr.start_epoch == 2
    sd = tr.state_dict()
    for name, t in sd["gpt"].items():
        np.testing.assert_array_equal(t.numpy(), ranks[0]["gpt"][name])
    for k in ("mu", "nu"):
        for a, b in zip(sd["opt"][k], ranks[0][k]):
            np.testing.assert_array_equal(a.numpy(), b)
    assert sd["step"] == 4 and tr.state.opt.count == 4
    assert torch.equal(sd["generator"], saved["generator"])


def test_tp2_warm_starts_from_a_reference_pt(tmp_path):
    """`--resume_path` to a reference-format `.pt` at `--tp 2`: each rank
    loads its slices of the full weights; after two steps at lr ~1e-6 the
    gathered GPT is still the file's within 1e-4 (a cold start is ~0.1
    away)."""
    cfg = tiny_cfg(tcfg)
    ours, _ = port_cat(seed=3)
    path = tmp_path / "cat.pt"
    torch.save({"transformer_model": ours.gpt.state_dict()}, path)
    ranks = launch("cat_cli", dict(cfg=cfg, argv=_cli_args(
        tmp_path, "--resume_path", str(path), "--tp", "2",
        "--save_every_epoch", "0")), 2, tmp_path)
    for name, t in ours.gpt.state_dict().items():
        err = np.abs(ranks[0]["gpt"][name] - t.numpy()).max()
        assert err <= 1e-4, (name, err)
