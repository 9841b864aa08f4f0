"""The port's FA-VAE train step against `favae_tpu.train.favae_step`, and the
port's train and eval CLIs, on the CPU.

Both packages start from one state: the JAX `FavaeTrainState.create` at the
tiny config of tests/test_train_step.py (FCM(Res), non-pairwise DSL, cosine
codebook, conv discriminator, f32, dropout 0), carried into the port by
favae_tpu_torch.convert (model, discriminator BatchNorm statistics, codebook
state, LPIPS). Each step runs on the same numpy batch, and after each step
the states are compared: losses and weight_d within 1e-4 relative; the
codebook EMA state and BatchNorm running statistics within 1e-5;
parameters within 2 lr at most and 0.01 lr on average, since Adam moves
every parameter by about lr * sign(g) and a gradient within rounding of
zero may take either sign. Then the port's model takes the JAX package's
parameters and buffers (its Adam moments stay its own), so the next step
tests the step again rather than the GAN's amplification of those flips:
left to run on, two f32 trajectories of this model drift apart by about
0.1 lr a parameter at the second step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from favae_tpu import config as jcfg
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.models.vqgan import VQGANFCM as JaxVQGAN
from favae_tpu.train.favae_state import FavaeTrainState as JaxState
from favae_tpu.train.favae_state import merge_params
from favae_tpu.train.favae_step import make_eval_step as jax_eval_step
from favae_tpu.train.favae_step import make_train_step as jax_train_step
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.cli import eval_favae, train_favae
from favae_tpu_torch.convert import from_jax_params, lpips_from_jax
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.models.lpips import LPIPS
from favae_tpu_torch.models.vqgan import VQGANFCM
from favae_tpu_torch.train.favae_state import FavaeTrainState
from favae_tpu_torch.train.favae_step import make_eval_step, make_train_step

LR = 1e-4
LOSS_KEYS = ("loss_g", "loss_l1", "loss_perceptual", "loss_recon", "loss_q",
             "loss_disc", "weight_d", "loss_ffl", "loss_dsl_features",
             "loss_d", "cb_batch_usage_pct", "cb_perplexity")


@pytest.fixture(autouse=True)
def _f32_torch():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(m):
    model = m.VQGANConfig(
        codec=m.CodecConfig(base_channels=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(), resolution=32, z_channels=64),
        quantizer=m.QuantizerConfig(codebook_size=64, dim=64,
                                    use_cosine_sim=True),
        discriminator=m.DiscriminatorConfig(kind="conv", num_layers=2),
        fcm_kind="res", dsl_mode="nonpair", compute_dtype="float32")
    losses = m.LossConfig(gaussian_kernel=3, dsl_init_sigma=1.0,
                          disc_start_epochs=0, ffl_start_epochs=0)
    return model, losses, m.TrainConfig(batch_size=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state_dict(state, cfg):
    """A JAX train state's model as the port's state_dict (numpy)."""
    params = _np_tree(merge_params(state.params_g, state.params_d))
    sd = from_jax_params(params, _np_tree(state.cb_state), cfg,
                         _np_tree(state.batch_stats))
    return {k: v.numpy() for k, v in sd.items()}


def _start():
    jm, jl, jt = _cfgs(jcfg)
    tm, tl, tt = _cfgs(tcfg)
    jstate, jmodel, tx_g, tx_d = JaxState.create(jm, jl, jt,
                                                 jax.random.PRNGKey(0), lr=LR)
    model = VQGANFCM(tm, gaussian_kernel=3, dsl_init_sigma=1.0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _jax_state_dict(jstate, tm).items()}, strict=True)
    tstate = FavaeTrainState.create(
        tm, tl, tt, LR, model=model,
        lpips_state_dict=lpips_from_jax(_np_tree(jstate.lpips_params)))
    lpips = JaxLPIPS(dtype=jnp.float32)

    @functools.lru_cache(maxsize=None)
    def jstep(disc_on, ffl_on):
        return jax.jit(jax_train_step(jmodel, lpips, tx_g, tx_d, jm, jl, jt,
                                      disc_on=disc_on, ffl_on=ffl_on))

    def tstep(disc_on, ffl_on):
        return make_train_step(tm, tl, tt, disc_on=disc_on, ffl_on=ffl_on)

    return jstate, tstate, jstep, tstep, tm


def _batch(seed):
    return (np.random.RandomState(seed).rand(4, 32, 32, 3) * 2 - 1).astype(
        np.float32)


def _compare_metrics(jm, tm, step):
    for k in LOSS_KEYS:
        if k not in jm:  # loss_ffl and loss_dsl_features with ffl_on off
            assert k not in tm
            continue
        ref, ours = float(jm[k]), float(tm[k])
        assert np.isfinite(ours), (step, k)
        assert abs(ours - ref) <= 1e-4 * abs(ref) + 1e-7, \
            f"step {step} {k}: port {ours} jax {ref}"


def _compare_and_sync(jstate, tstate, cfg):
    """Compare the two models after a step, then give the port the JAX
    package's parameters and buffers."""
    ref = _jax_state_dict(jstate, cfg)
    ours = {k: v.detach().numpy() for k, v in
            tstate.model.state_dict().items()}
    assert ref.keys() == ours.keys()
    errs = []
    for k in ref:
        if k.endswith("num_batches_tracked"):  # the JAX package has none
            continue
        err = np.abs(ours[k].astype(np.float64) - ref[k])
        if k.startswith("quantizer.") or "running_" in k:
            assert err.max() <= 1e-5, f"{k}: {err.max()}"
        else:
            errs.append(err.ravel())
            assert err.max() <= 2 * LR, f"{k}: {err.max()}"
    assert np.concatenate(errs).mean() <= 0.01 * LR
    tstate.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in ref.items()})


@pytest.mark.parametrize("gates", [
    ((True, True), (True, True)),     # two steps with D and FFL
    ((False, True), (False, False)),  # D off: BatchNorm statistics only
])
def test_train_steps_match_jax(gates):
    jstate, tstate, jstep, tstep, cfg = _start()
    for i, (disc_on, ffl_on) in enumerate(gates):
        x = _batch(10 + i)
        jstate, jm = jstep(disc_on, ffl_on)(jstate, jnp.asarray(x),
                                           jax.random.PRNGKey(1))
        tstate, tm = tstep(disc_on, ffl_on)(tstate, torch.from_numpy(x))
        _compare_metrics(jm, tm, i)
        np.testing.assert_allclose(tm["x_recon"].numpy(),
                                   np.asarray(jm["x_recon"]), atol=1e-4)
        _compare_and_sync(jstate, tstate, cfg)
    assert tstate.step == len(gates)


def test_eval_step_matches_jax():
    jstate, tstate, _, _, _ = _start()
    jm, jl, _ = _cfgs(jcfg)
    ev = jax.jit(jax_eval_step(JaxVQGAN(jm, gaussian_kernel=3,
                                        dsl_init_sigma=1.0),
                               JaxLPIPS(dtype=jnp.float32), jl))
    x = _batch(3)
    ref = ev(jstate, jnp.asarray(x))
    ours = make_eval_step(_cfgs(tcfg)[1])(tstate, torch.from_numpy(x))
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


def test_train_cli_on_cpu(tmp_path):
    """A small flag-built FCM(Res) + non-pairwise DSL model for two epochs
    (the discriminator from the second), 2 steps each, plus validation."""
    out = train_favae.main([
        "--ds", "smoke", "--output_dir", str(tmp_path), "--device", "cpu",
        "--use_gauss_resblock", "--downsample_factor", "4",
        "--resolution", "32", "--embed_dim", "32", "--codebook_size", "64",
        "--gaussian_kernel", "3",
        "--use_cosine_sim", "--ffl_weight", "1.0",
        "--DSL_weight_features", "0.01", "--disc_n_layers", "2",
        "--synthetic_data", "--synthetic_steps", "2", "--batch_size", "2",
        "--epochs", "2", "--disc_start_epochs", "1", "--num_workers", "1",
        "--compute_dtype", "float32", "--print_steps", "1"])
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


@pytest.mark.parametrize("flag", [["--resume"], ["--kmeans_init"],
                                  ["--adam_mu_dtype", "bfloat16"],
                                  ["--save_every_epoch", "2"]])
def test_train_cli_names_what_is_not_ported(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_favae.main(["--ds", "x", "--output_dir", str(tmp_path),
                          "--device", "cpu", *flag])


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

