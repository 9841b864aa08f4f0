"""Faults found in the port against the reference, each held on the CPU.

- The image loader skips what the reference skips: any image that fails to
  open, Pillow's `DecompressionBombError` (not an `OSError`) included.
- `vq_nearest`'s arrival counters belong to one (device, stream): launches
  in flight on two streams never share them, and they are never made inside
  a CUDA-graph capture. The launches themselves run only on the card
  (`chip_smoke.py::check_vq_streams`); the keying is Python and is held here.
"""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from favae_tpu.data import pipeline as jax_pipeline
from favae_tpu_torch.data import pipeline
from favae_tpu_torch.ops import vq


@pytest.fixture
def manifest_with_a_bomb(tmp_path, monkeypatch):
    """A manifest of a 64 x 64 PNG that Pillow refuses as a decompression
    bomb (the limit lowered to 1000 pixels) and then a good 16 x 16 one."""
    rng = np.random.RandomState(0)
    bomb, good = tmp_path / "bomb.png", tmp_path / "good.png"
    Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(bomb)
    pixels = rng.randint(0, 256, (16, 16, 3), np.uint8)
    Image.fromarray(pixels).save(good)
    path = tmp_path / "manifest.pkl"
    with open(path, "wb") as f:
        pickle.dump([str(bomb), str(good)], f)
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 1000)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(bomb)
    return str(path), (pixels.astype(np.float32) / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("loader", [pipeline, jax_pipeline],
                         ids=["port", "reference"])
def test_loader_skips_a_decompression_bomb(manifest_with_a_bomb, loader):
    path, want = manifest_with_a_bomb
    ds = loader.PklImageDataset(path, 16)
    np.testing.assert_allclose(ds.get(0), want, atol=1e-6)
    np.testing.assert_allclose(ds.get(1), want, atol=1e-6)


def test_both_loaders_agree_past_a_bomb(manifest_with_a_bomb):
    path, _ = manifest_with_a_bomb
    np.testing.assert_array_equal(pipeline.PklImageDataset(path, 16).get(0),
                                  jax_pipeline.PklImageDataset(path, 16).get(0))


@pytest.fixture
def counters():
    before = dict(vq._ARRIVED)
    yield vq._arrived
    vq._ARRIVED.clear()
    vq._ARRIVED.update(before)


def test_vq_counters_are_one_set_a_stream(counters):
    cpu = torch.device("cpu")
    a, b = counters(cpu, 11, False), counters(cpu, 12, False)
    assert a is not b
    assert counters(cpu, 11, False) is a          # made once a stream
    assert a.shape == (vq.MAX_TILES,) and a.dtype == torch.int32
    assert int(a.abs().sum()) == 0                 # zero between launches
    meta = counters(torch.device("meta"), 11, False)
    assert meta is not a                           # and once a device


def test_vq_counters_are_never_made_in_a_capture(counters):
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="captured by a CUDA graph"):
        counters(cpu, 21, True)
    assert (cpu, 21) not in vq._ARRIVED
    made = counters(cpu, 21, False)                # warmed up first ...
    assert counters(cpu, 21, True) is made         # ... the capture reuses it
