"""The port's MetricWriter against favae_tpu.utils.logging's, and what the
trainers log, on the CPU.

Both writers get a stub in place of the SummaryWriter that records every
call; on the same inputs they must hand it the same scalars and the same
image arrays (the recon grid and the captioned sample grid).
"""

import builtins

import numpy as np
import pytest
import torch

from favae_tpu.utils import logging as jlog
from favae_tpu_torch.utils import logging as tlog
from tests.torch_threads import one_torch_thread  # noqa: F401


class _Stub:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, value, step))

    def add_image(self, tag, img, step, dataformats):
        self.calls.append(("image", tag, np.asarray(img), step, dataformats))

    def flush(self):
        pass

    def close(self):
        self.calls.append(("close",))


def _writers():
    ours, ref = tlog.MetricWriter(None), jlog.MetricWriter(None)
    ours._writer, ref._writer = _Stub(), _Stub()
    return ours, ref


def _same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("n", [4, 3, 1])
def test_grids_and_scalars_match_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.rand(n, 8, 12, 3) * 2.4 - 1.2).astype(np.float32)
    y = (rng.rand(n, 8, 12, 3) * 2 - 1).astype(np.float32)
    caps = [f"a fairly long caption number {i} that wraps" for i in range(n)]
    ours, ref = _writers()
    for w, tensors in ((ours, True), (ref, False)):
        xs, ys = ((torch.from_numpy(x), torch.from_numpy(y)) if tensors
                  else (x, y))
        w.scalars("train", {"loss": 0.5, "bad": "x", "n": 3}, 7)
        w.recon_grid("train/img-recon", xs, ys, 7)
        w.caption_grid("val/from-cond", xs, ys, caps, 2)
        w.close()
    _same_calls(ours._writer.calls, ref._writer.calls)
    assert ours._writer.calls[-1] == ("close",)


def test_writer_without_tensorboard_says_so(monkeypatch, tmp_path, capsys):
    real = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    w = tlog.MetricWriter(str(tmp_path / "runs"))
    assert w._writer is None
    assert "no metrics or images are written" in capsys.readouterr().out
    w.scalars("train", {"a": 1.0}, 0)
    w.recon_grid("x", np.zeros((1, 2, 2, 3)), np.zeros((1, 2, 2, 3)), 0)
    w.close()
    assert tlog.MetricWriter(None)._writer is None
    assert tlog.device_memory_mib("cpu") == 0.0


def test_favae_trainer_logs_what_jax_logs(tmp_path):
    """Scalars on print steps (every loss, imgs_per_sec, mem_mib, the
    sigmas) at the global step, a recon grid on img_steps, the val
    scalars and grid at the epoch."""
    from tests.test_torch_port_checkpoint import _favae_trainer
    tr, train, val = _favae_trainer(tmp_path)
    tr.writer._writer = _Stub()
    tr.fit(train, val, epochs=1)
    calls = tr.writer._writer.calls
    scalars = {(c[1], c[3]) for c in calls if c[0] == "scalar"}
    for k in ("loss_g", "loss_l1", "weight_d", "imgs_per_sec", "mem_mib",
              "sigma_0", "sigma_3"):
        assert (f"train/{k}", 0) in scalars, k
    assert ("val/loss_recon", 0) in scalars
    images = [(c[1], c[3], c[2].shape) for c in calls if c[0] == "image"]
    assert images == [("train/img-recon", 0, (64, 64, 3)),
                      ("val/img-recon", 0, (64, 64, 3))]
    assert calls[-1] == ("close",)
