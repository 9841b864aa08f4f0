"""Image (and caption) input pipeline (numpy + PIL only).

A copy of the image and caption parts of `favae_tpu/data/pipeline.py`: the
port imports nothing of the JAX package. Semantics are the reference's
(datasets/general_dataloader.py, and general_dataloader_gpt.py for
[path, caption] manifests): Resize((r, r)) -> scale to [0, 1] -> normalise
with mean/std 0.5, giving HWC float32 pixels in [-1, 1]; unreadable images
fall through to the next index. Batches are NHWC numpy arrays (with a list
of captions beside them for caption datasets), decoded in a thread pool,
optionally shuffled per epoch.
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
    """Images of a pkl manifest (paths, or [path, caption] entries); with
    `with_captions`, (image, caption) items of a [path, caption] one."""

    def __init__(self, manifest_path: str, resolution: int,
                 with_captions: bool = False):
        if not _HAVE_PIL:
            raise RuntimeError("PIL is required for image loading")
        self.entries = load_manifest(manifest_path)
        self.resolution = resolution
        self.with_captions = with_captions

    def __len__(self):
        return len(self.entries)

    def get(self, index: int):
        """The item at `index`, skipping forward over unreadable files."""
        for probe in range(index, index + len(self.entries)):
            e = self.entries[probe % len(self.entries)]
            img = _load_image(e[0] if isinstance(e, (list, tuple)) else e)
            if img is not None:
                x = _transform(img, self.resolution)
                return (x, e[1]) if self.with_captions else x
        raise RuntimeError("no readable image in manifest")


class SyntheticDataset:
    """Deterministic random images in [-1, 1] (benchmarks, smoke runs), with
    the JAX package's dummy captions when asked."""

    def __init__(self, resolution: int, size: int = 1024, seed: int = 0,
                 with_captions: bool = False):
        self.resolution = resolution
        self.size = size
        self.seed = seed
        self.with_captions = with_captions

    def __len__(self):
        return self.size

    def get(self, index: int):
        rng = np.random.RandomState(self.seed + index % self.size)
        r = self.resolution
        x = rng.rand(r, r, 3).astype(np.float32) * 2 - 1
        if self.with_captions:
            return x, f"synthetic caption {index % self.size}"
        return x


class DataLoader:
    """Batches of a dataset decoded a few batches ahead by a thread pool:
    NHWC numpy arrays, or for items that are tuples a tuple of columns, the
    array columns stacked and the others (captions) lists. A last partial
    batch is dropped unless `drop_last` is false. With `shuffle`, each
    epoch visits the samples in a permutation seeded by `seed + epoch`
    (`set_epoch`), as the JAX package's loader does
    (favae_tpu/data/pipeline.py:158-220); without, in order."""

    PREFETCH = 2  # batches decoded ahead of the consumer

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        if self.drop_last:
            return len(self.ds) // self.batch_size
        return -(-len(self.ds) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    @staticmethod
    def collate(items):
        if isinstance(items[0], np.ndarray):
            return np.stack(items)
        return tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                     else list(col) for col in zip(*items))

    def __iter__(self) -> Iterator:
        n_batches = len(self)
        idx = self._indices()

        def fetch(b):
            lo = b * self.batch_size
            return self.collate([self.ds.get(int(i))
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
