"""The port's FA-VAE train options data parallel over 2 gloo ranks on the
CPU, against the JAX package's step on the global batch.

One train step with gumbel sampling, dead-code expiry and the orthogonal
regulariser on 16 of 64 codes, with JAX's draws for the global batch of 4
(each rank takes its rows of the gumbel noise; the expiry candidates index
the global rows): slice 2's bounds against the JAX step
(tests/favae_train_common.py), `cb_replaced` equal, and the ranks equal
bit for bit. The first-batch inits (k-means, ActNorm) and validation are
in tests/test_torch_port_ddp_favae_init.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from favae_tpu import config as jcfg
from favae_tpu.models.lpips import LPIPS as JaxLPIPS
from favae_tpu.train.favae_state import FavaeTrainState as JaxState
from favae_tpu.train.favae_step import make_train_step as jax_train_step
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.convert import lpips_from_jax
from tests.favae_train_common import (LR, _compare_metrics, _jax_state_dict,
                                      _np_tree, batch, f32_torch)  # noqa: F401
from tests.test_torch_port_ddp_favae import compare_to_jax
from tests.test_torch_port_train_options import _jax_draws, _option_cfgs
from tests.torch_dist_worker import launch
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_dp2_step_with_codebook_options_matches_jax(tmp_path):
    q = dict(sample_codebook_temp=1.0, threshold_ema_dead_code=3.0,
             orthogonal_reg_weight=10.0, orthogonal_reg_max_codes=16)

    def cfgs(m):
        model, losses, train = _option_cfgs(m, **q)
        return (dataclasses.replace(model, discriminator=m.DiscriminatorConfig(
            kind="conv", num_layers=2)), losses,
            dataclasses.replace(train, batch_size=2,
                                faithful_stage1_recompute=False))

    jm, jl, jt = cfgs(jcfg)
    tm, tl, tt = cfgs(tcfg)
    jstate, jmodel, tx_g, tx_d = JaxState.create(jm, jl, jt,
                                                 jax.random.PRNGKey(0), lr=LR)
    x = batch(10)
    key = jax.random.PRNGKey(1)
    _, k_vq0, k_vq1, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    draws = [_jax_draws(k, 4 * 16 * 16, 64, 16) for k in (k_vq0, k_vq1)]
    lpips = {k: v.numpy() for k, v in
             lpips_from_jax(_np_tree(jstate.lpips_params)).items()}
    ranks = launch("favae_step", dict(
        cfgs=(tm, tl, tt), lr=LR, model=_jax_state_dict(jstate, tm),
        lpips=lpips, x=[x], gates=[(True, True)], draws=[draws]), 2,
        tmp_path)

    jstep = jax.jit(jax_train_step(jmodel, JaxLPIPS(dtype=jnp.float32), tx_g,
                                   tx_d, jm, jl, jt, disc_on=True,
                                   ffl_on=True))
    jstate, jmet = jstep(jstate, jnp.asarray(x), key)
    m = ranks[0]["metrics"][0]
    _compare_metrics(jmet, m, 0)
    assert m["cb_replaced"] == float(jmet["cb_replaced"]) > 0
    compare_to_jax(_jax_state_dict(jstate, tm), ranks[0]["model"])
    for k, v in ranks[0]["model"].items():
        np.testing.assert_array_equal(ranks[1]["model"][k], v, err_msg=k)

