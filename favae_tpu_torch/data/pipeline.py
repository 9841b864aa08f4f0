"""Image input pipeline (numpy + PIL only).

A copy of the image-only part of `favae_tpu/data/pipeline.py`: the port
imports nothing of the JAX package. Semantics are the reference's
(datasets/general_dataloader.py): Resize((r, r)) -> scale to [0, 1] ->
normalise with mean/std 0.5, giving HWC float32 pixels in [-1, 1];
unreadable images fall through to the next index. Batches are NHWC numpy
arrays, decoded in a thread pool, optionally shuffled per epoch.
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np

try:
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False

MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
STD = np.asarray([0.5, 0.5, 0.5], np.float32)


def load_manifest(path: str) -> List:
    """A reference-format pkl manifest: a list of paths, or of
    [path, caption]. Unpickling runs code: load only manifests you made."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _load_image(path: str):
    try:
        img = Image.open(path)
        return img if img.mode == "RGB" else img.convert("RGB")
    except Exception:  # unreadable, truncated, or a decompression bomb
        return None


def _transform(img, resolution: int) -> np.ndarray:
    img = img.resize((resolution, resolution), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return (x - MEAN) / STD


class PklImageDataset:
    """Images of a pkl manifest (paths, or [path, caption] entries)."""

    def __init__(self, manifest_path: str, resolution: int):
        if not _HAVE_PIL:
            raise RuntimeError("PIL is required for image loading")
        self.entries = load_manifest(manifest_path)
        self.resolution = resolution

    def __len__(self):
        return len(self.entries)

    def get(self, index: int) -> np.ndarray:
        """The image at `index`, skipping forward over unreadable files."""
        for probe in range(index, index + len(self.entries)):
            e = self.entries[probe % len(self.entries)]
            img = _load_image(e[0] if isinstance(e, (list, tuple)) else e)
            if img is not None:
                return _transform(img, self.resolution)
        raise RuntimeError("no readable image in manifest")


class SyntheticDataset:
    """Deterministic random images in [-1, 1] (benchmarks, smoke runs)."""

    def __init__(self, resolution: int, size: int = 1024, seed: int = 0):
        self.resolution = resolution
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.size

    def get(self, index: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + index % self.size)
        r = self.resolution
        return rng.rand(r, r, 3).astype(np.float32) * 2 - 1


class DataLoader:
    """Full batches of a dataset (a last partial batch is dropped), as NHWC
    numpy arrays decoded a few batches ahead by a thread pool. With
    `shuffle`, each epoch visits the samples in a permutation seeded by
    `seed + epoch` (`set_epoch`), as the JAX package's loader does
    (favae_tpu/data/pipeline.py:158-220); without, in order."""

    PREFETCH = 2  # batches decoded ahead of the consumer

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 shuffle: bool = False, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.ds) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        n_batches = len(self)
        idx = self._indices()

        def fetch(b):
            lo = b * self.batch_size
            return np.stack([self.ds.get(int(i))
                             for i in idx[lo:lo + self.batch_size]])

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(fetch, b)
                       for b in range(min(self.PREFETCH + 1, n_batches))]
            next_submit = len(pending)
            for _ in range(n_batches):
                out = pending.pop(0).result()
                if next_submit < n_batches:
                    pending.append(pool.submit(fetch, next_submit))
                    next_submit += 1
                yield out
