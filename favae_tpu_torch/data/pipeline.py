"""Image (and caption) input pipeline (numpy + PIL only).

A copy of the image and caption parts of `favae_tpu/data/pipeline.py`: the
port imports nothing of the JAX package. Semantics are the reference's
(datasets/general_dataloader.py, and general_dataloader_gpt.py for
[path, caption] manifests): Resize((r, r)) -> scale to [0, 1] -> normalise
with mean/std 0.5, giving HWC float32 pixels in [-1, 1]; unreadable images
fall through to the next index. Batches are NHWC numpy arrays (with a list
of captions beside them for caption datasets), decoded in a thread pool
or, with `use_processes`, in a persistent pool of worker processes,
optionally shuffled per epoch. `output_dtype="uint8"` ships the resized
pixels as they are, and the train and eval steps normalise them on the
device (`train/favae_step.py::to_unit_range`) with the reference's op
sequence. `with_clip_image` adds CLIP's view of each captioned image
(bicubic 224 x 224, CLIP's mean and std). `shard_index` / `shard_count`
give a rank of a data-parallel run its shard of every epoch, as the JAX
loader gives a host its shard. `STATS` counts the loader's hand-overs, and
the consumer's wait for a batch is the span `data.wait`.
"""

from __future__ import annotations

import multiprocessing
import pickle
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from favae_tpu_torch.profiling import span

try:
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False

MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
STD = np.asarray([0.5, 0.5, 0.5], np.float32)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

# every `DataLoader`'s counters, kept on the consumer's thread: batches
# handed over, those whose decode had finished when asked for, host seconds
# waited for them (`data.wait`) and the seconds their workers took to
# decode them
STATS = {"batches": 0, "ready": 0, "wait_s": 0.0, "decode_s": 0.0}


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


def _transform_uint8(img, resolution: int) -> np.ndarray:
    """Resize only; the step normalises on the device."""
    img = img.resize((resolution, resolution), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def _clip_transform(img) -> np.ndarray:
    """CLIP's view: bicubic 224 x 224, CLIP's mean and std
    (favae_tpu/data/pipeline.py:78-83)."""
    img = img.resize((224, 224), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


class PklImageDataset:
    """Images of a pkl manifest (paths, or [path, caption] entries); with
    `with_captions`, (image, caption) items of a [path, caption] one, and
    with `with_clip_image` too (image, CLIP image, caption) items.
    `output_dtype` "float32" gives pixels in [-1, 1], "uint8" the resized
    pixels (favae_tpu/data/pipeline.py:96-121)."""

    def __init__(self, manifest_path: str, resolution: int,
                 with_captions: bool = False, output_dtype: str = "float32",
                 with_clip_image: bool = False):
        if not _HAVE_PIL:
            raise RuntimeError("PIL is required for image loading")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"output_dtype {output_dtype!r} is not "
                             "float32 or uint8")
        self.entries = load_manifest(manifest_path)
        self.resolution = resolution
        self.with_captions = with_captions
        self.with_clip_image = with_clip_image
        self.output_dtype = output_dtype

    def __len__(self):
        return len(self.entries)

    def get(self, index: int):
        """The item at `index`, skipping forward over unreadable files."""
        for probe in range(index, index + len(self.entries)):
            e = self.entries[probe % len(self.entries)]
            img = _load_image(e[0] if isinstance(e, (list, tuple)) else e)
            if img is not None:
                x = (_transform_uint8 if self.output_dtype == "uint8"
                     else _transform)(img, self.resolution)
                if not self.with_captions:
                    return x
                if self.with_clip_image:
                    return x, _clip_transform(img), e[1]
                return x, e[1]
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


# process-pool workers, module-level so that they pickle by reference
_WORKER_DS = None


def _proc_init(ds) -> None:
    global _WORKER_DS
    _WORKER_DS = ds


def _proc_fetch(indices) -> Tuple[List, float]:
    t0 = time.perf_counter()
    items = [_WORKER_DS.get(int(i)) for i in indices]
    return items, time.perf_counter() - t0


class DataLoader:
    """Batches of a dataset decoded a few batches ahead by a thread pool:
    NHWC numpy arrays, or for items that are tuples a tuple of columns, the
    array columns stacked and the others (captions) lists. A last partial
    batch is dropped unless `drop_last` is false. With `shuffle`, each
    epoch visits the samples in a permutation seeded by `seed + epoch`
    (`set_epoch`), as the JAX package's loader does
    (favae_tpu/data/pipeline.py:158-220); without, in order.

    `use_processes` decodes in a persistent pool of `num_workers` worker
    processes instead of threads (favae_tpu/data/pipeline.py:186-243), made
    at the first batch and kept until `close()`. They start from a
    forkserver (a forked child of a process that has initialised CUDA is
    unusable), so the dataset must pickle.

    `shard_index` / `shard_count` keep every `shard_count`-th sample of
    the epoch's order from `shard_index` on, the shards of one shared
    permutation, and `len` counts the shard's batches
    (favae_tpu/data/pipeline.py:175-221)."""

    PREFETCH = 2  # batches decoded ahead of the consumer

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, use_processes: bool = False,
                 shard_index: int = 0, shard_count: int = 1):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.use_processes = use_processes
        self.shard_index, self.shard_count = shard_index, shard_count
        self.epoch = 0
        self._pool = None

    def _process_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            methods = multiprocessing.get_all_start_methods()
            ctx = multiprocessing.get_context(
                "forkserver" if "forkserver" in methods else "spawn")
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=ctx, initializer=_proc_init,
                initargs=(self.ds,))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes, if any."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __len__(self):
        n = len(self.ds) // self.shard_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index::self.shard_count]

    @staticmethod
    def collate(items):
        if isinstance(items[0], np.ndarray):
            return np.stack(items)
        return tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                     else list(col) for col in zip(*items))

    def __iter__(self) -> Iterator:
        n_batches = len(self)
        idx = self._indices()

        def indices(b):
            return idx[b * self.batch_size:(b + 1) * self.batch_size]

        if self.use_processes:
            yield from self._run(self._process_pool(),
                                 lambda b: (_proc_fetch, indices(b)),
                                 n_batches, self.collate)
            return

        def fetch(b):
            t0 = time.perf_counter()
            out = self.collate([self.ds.get(int(i)) for i in indices(b)])
            return out, time.perf_counter() - t0

        with ThreadPoolExecutor(self.num_workers) as pool:
            yield from self._run(pool, lambda b: (fetch, b), n_batches,
                                 lambda out: out)

    def _run(self, pool, job, n_batches, finish) -> Iterator:
        """Batches in order, `PREFETCH` + 1 of them submitted ahead. A job
        returns its result and the seconds its worker took; both are
        counted here, on the consumer's thread."""
        pending, next_submit = [], 0
        for _ in range(n_batches):
            t0 = time.perf_counter()
            with span("data.wait"):
                if next_submit == 0:  # the epoch's first submissions
                    pending = [pool.submit(*job(b)) for b in
                               range(min(self.PREFETCH + 1, n_batches))]
                    next_submit = len(pending)
                fut = pending.pop(0)
                ready = fut.done()
                res, decode_s = fut.result()
            STATS["wait_s"] += time.perf_counter() - t0
            STATS["batches"] += 1
            STATS["ready"] += ready
            STATS["decode_s"] += decode_s
            out = finish(res)
            if next_submit < n_batches:
                pending.append(pool.submit(*job(next_submit)))
                next_submit += 1
            yield out
