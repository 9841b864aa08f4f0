"""The port's FA-VAE trainer data parallel over 2 gloo ranks on the CPU:
its first-batch inits and validation against the JAX trainer.

With each rank on its half of the first global batch of 8: k-means (4
iterations, 64 codes over the gathered 2048 codebook inputs, JAX's first
permutation) within 1e-5 of the JAX trainer's on its mesh, every code
counted once; the 2 ActNorms of D(x_recon) from the global batch's
statistics, 1e-5 relative; the ranks equal bit for bit. Then validation
over each rank's shard of 8 images is the global mean: equal to the
port's one-process score within 1e-6 relative. The lr counts every rank
as the JAX trainer counts every device.
"""

import dataclasses

import jax
import numpy as np
import torch

from favae_tpu import config as jcfg
from favae_tpu.train.favae_trainer import FavaeTrainer as JaxTrainer
from favae_tpu_torch import config as tcfg
from favae_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from favae_tpu_torch.train.favae_trainer import FavaeTrainer
from tests.favae_train_common import _jax_state_dict, f32_torch  # noqa: F401
from tests.test_torch_port_train_options import _option_cfgs, _rel, _t
from tests.torch_dist_worker import ArrayDataset, launch
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_dp2_first_batch_inits_and_validation(tmp_path):
    q = dict(kmeans_init=True, kmeans_iters=4)
    jm, jl, jt = _option_cfgs(jcfg, **q)
    tm, tl, tt = _option_cfgs(tcfg, **q)
    tt = dataclasses.replace(tt, batch_size=4)  # a rank's share of 8
    jtr = JaxTrainer(jm, jl, jt, str(tmp_path / "jax"))
    sd = _jax_state_dict(jtr.state, tm)
    ds = SyntheticDataset(32, size=8, seed=5)
    x0 = np.stack([ds.get(i) for i in range(8)])
    val = np.stack([SyntheticDataset(32, size=8, seed=9).get(i)
                    for i in range(8)])
    _, key = jax.random.split(jtr.rng)  # the key the JAX init draws next
    first = np.array(jax.random.permutation(key, 8 * 16 * 16))
    ranks = launch("favae_init", dict(
        cfgs=(tm, tl, tt), model=sd, x0=x0, first=first, val=val,
        val_batch=2, save_dir=str(tmp_path / "port")), 2, tmp_path)

    jtr._data_dependent_init(x0)
    ref = _jax_state_dict(jtr.state, tm)
    ours = ranks[0]["model"]
    for k in ("quantizer._codebook.embed", "quantizer._codebook.cluster_size"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-5)
    assert ours["quantizer._codebook.cluster_size"].sum() == 2048
    layers = [k for k in ref if k.endswith((".loc", ".scale"))]
    assert len(layers) == 4
    for k in layers:
        assert _rel(ours[k], ref[k]) <= 1e-5, k
    for k, v in ours.items():
        np.testing.assert_array_equal(ranks[1]["model"][k], v, err_msg=k)
    # lr = base_lr * batch * world in both packages (JAX: 8 devices)
    assert ranks[0]["lr"] / (tt.batch_size * 2) == jtr.lr / (
        jt.batch_size * jax.device_count())

    one = FavaeTrainer(tm, tl, tt, str(tmp_path / "one"), device="cpu")
    one.state.model.load_state_dict({k: torch.from_numpy(v)
                                     for k, v in sd.items()})
    one._data_dependent_init(x0, _t(first).long())
    score = one.validate(DataLoader(ArrayDataset(val), 2), 0)
    for r in ranks:
        assert r["val"]["images"] == 8
        assert abs(r["score"] - score) <= 1e-6 * abs(score), (r["score"],
                                                              score)
