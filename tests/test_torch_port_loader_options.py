"""The port's loader options on the CPU: uint8 batches (resized pixels,
normalised on the device by the step) and decoding in a persistent pool of
worker processes, against the JAX package's loader and the port's thread
loader, and both through `cli.train_favae` on a PNG manifest."""

import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from favae_tpu.data.pipeline import DataLoader as JaxLoader
from favae_tpu.data.pipeline import PklImageDataset as JaxDataset
from favae_tpu_torch.cli import train_favae
from favae_tpu_torch.data.pipeline import DataLoader, PklImageDataset
from tests.torch_threads import one_torch_thread  # noqa: F401


def _manifest(root, n, size=40, name="train.pkl"):
    """`n` seeded RGB PNGs of `size` px and a pkl manifest of their paths."""
    rng = np.random.RandomState(n)
    paths = []
    for i in range(n):
        p = root / f"{name}_{i}.png"
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(p)
        paths.append(str(p))
    with open(root / name, "wb") as f:
        pickle.dump(paths, f)
    return str(root / name)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_batches_equal_the_jax_loaders(tmp_path, dtype):
    """The same manifest, resolution and shuffle seed: bit for bit the
    JAX loader's batches, uint8 resized pixels or f32 in [-1, 1]."""
    path = _manifest(tmp_path, 6)
    ours = DataLoader(PklImageDataset(path, 32, output_dtype=dtype), 2,
                      num_workers=2, shuffle=True, seed=3)
    ref = JaxLoader(JaxDataset(path, 32, output_dtype=dtype), batch_size=2,
                    shuffle=True, seed=3, num_workers=2)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.dtype(dtype)
            assert a.shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(a, b)


def test_process_loader_gives_the_thread_loaders_batches(tmp_path):
    """Worker processes from a forkserver, kept across epochs until
    `close()`: the same batches in the same order as the thread loader,
    in both dtypes."""
    path = _manifest(tmp_path, 8)
    for dtype in ("uint8", "float32"):
        ds = PklImageDataset(path, 24, output_dtype=dtype)
        procs = DataLoader(ds, 3, num_workers=2, shuffle=True, seed=1,
                           use_processes=True)
        threads = DataLoader(ds, 3, num_workers=2, shuffle=True, seed=1)
        try:
            for epoch in (0, 1):
                procs.set_epoch(epoch)
                threads.set_epoch(epoch)
                got, want = list(procs), list(threads)
                assert len(got) == len(want) == 2
                for a, b in zip(got, want):
                    assert a.dtype == np.dtype(dtype)
                    np.testing.assert_array_equal(a, b)
            pool = procs._pool
            assert pool is not None
        finally:
            procs.close()
        assert procs._pool is None


def test_train_cli_with_uint8_and_process_loaders(tmp_path):
    """`cli.train_favae --loader_uint8 --loader_processes` on a 16-image
    PNG manifest (and a 4-image val manifest) at 16 px: two epochs of 4
    steps, the discriminator from the second, finite losses, validation of
    4 images, the recon grids written from the uint8 batches."""
    train = _manifest(tmp_path, 16)
    val = _manifest(tmp_path, 4, name="val.pkl")
    out = train_favae.main([
        "--ds", "u8", "--output_dir", str(tmp_path / "out"), "--device",
        "cpu", "--train_file", train, "--test_file", val,
        "--loader_uint8", "--loader_processes", "--num_workers", "2",
        "--downsample_factor", "4", "--resolution", "16", "--embed_dim", "8",
        "--codebook_size", "16", "--num_groups", "8", "--use_cosine_sim",
        "--disc_n_layers", "2", "--batch_size", "4", "--epochs", "2",
        "--disc_start_epochs", "1", "--compute_dtype", "float32",
        "--print_steps", "1", "--img_steps", "1"])
    assert (tmp_path / "out" / "u8" / "best").is_dir()
    shutil.rmtree(tmp_path / "out")  # ~1 GB of checkpoints
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [0] * 4 + [1] * 4
    assert all(np.isfinite(h["loss_g"]) for h in hist)
    assert hist[-1]["loss_d"] > 0.0
    assert [v["images"] for v in out["val"]] == [4, 4]
    assert all(np.isfinite(v["loss_recon"]) for v in out["val"])
