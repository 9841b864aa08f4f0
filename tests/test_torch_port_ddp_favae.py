"""The port's FA-VAE train step data parallel over 2 gloo ranks on the CPU,
against the JAX package's single-device step on the global batch (the
pattern of tests/test_train_step.py::test_train_step_sharded_over_mesh)
and against the port's own step in one process.

The tiny config of tests/favae_train_common.py, one step with D and FFL
on, a global batch of 4 split 2 a rank. The JAX global-view step reduces
over the whole batch, so the ranks must too: the codebook EMA's bins and
sums, the discriminator's BatchNorm statistics (forward and backward),
the adaptive weight from the averaged final-conv gradients, the averaged
parameter gradients, the logged means.

- Against JAX: the losses and weight_d within 1e-4 relative, the codebook
  state and BatchNorm running statistics within 1e-5, the parameters
  within 2 lr at most and 0.01 lr on average (slice 2's bounds).
- Against the port in one process on the same batch: the losses within
  1e-5 relative, the codebook and BatchNorm state within 1e-6.
- Both ranks end with the same model, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from favae_tpu_torch import config as tcfg
from tests.favae_train_common import (LOSS_KEYS, LR, _compare_metrics,
                                      _jax_state_dict, batch, cfgs,
                                      f32_torch, start)  # noqa: F401
from tests.torch_dist_worker import launch
from tests.torch_threads import one_torch_thread  # noqa: F401

STATE_ABS = 1e-6  # codebook and BatchNorm state against the 1-process step
LOSS_REL = 1e-5   # losses against the 1-process step


def np_sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def compare_to_jax(ref, ours):
    """slice 2's bounds (tests/favae_train_common.py)."""
    errs = []
    for k in ref:
        if k.endswith("num_batches_tracked"):
            continue
        err = np.abs(ours[k].astype(np.float64) - ref[k])
        if k.startswith("quantizer.") or "running_" in k:
            assert err.max() <= 1e-5, f"{k}: {err.max()}"
        else:
            errs.append(err.ravel())
            assert err.max() <= 2 * LR, f"{k}: {err.max()}"
    assert np.concatenate(errs).mean() <= 0.01 * LR


def test_dp2_step_matches_jax_and_one_process(tmp_path):
    jstate, tstate, jstep, tstep, cfg = start()
    x = batch(10)
    inputs = dict(cfgs=cfgs(tcfg), lr=LR, model=np_sd(tstate.model),
                  lpips=np_sd(tstate.lpips), x=[x], gates=[(True, True)])
    ranks = launch("favae_step", inputs, 2, tmp_path)

    jstate, jm = jstep(True, True)(jstate, jnp.asarray(x),
                                   jax.random.PRNGKey(1))
    _compare_metrics(jm, ranks[0]["metrics"][0], 0)
    compare_to_jax(_jax_state_dict(jstate, cfg), ranks[0]["model"])

    tstate, tm = tstep(True, True)(tstate, torch.from_numpy(x))
    for k in LOSS_KEYS:
        if k in tm:
            ref, ours = float(tm[k]), ranks[0]["metrics"][0][k]
            assert abs(ours - ref) <= LOSS_REL * abs(ref) + 1e-8, (k, ours,
                                                                   ref)
    one = np_sd(tstate.model)
    for k, v in one.items():
        if k.startswith("quantizer.") or "running_" in k:
            err = np.abs(ranks[0]["model"][k] - v).max()
            assert err <= STATE_ABS, (k, err)

    for k, v in ranks[0]["model"].items():  # the ranks agree bit for bit
        np.testing.assert_array_equal(ranks[1]["model"][k], v, err_msg=k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
