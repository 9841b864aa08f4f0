"""The cells' inputs, made from the seed: an image set written as JPEG files
with a reference-format pkl manifest (a list of paths), as a user's
CelebA-HQ folder would be, and the plain decoding that the reference
applies to the same files.

Images are made on the device in batches from a `torch.Generator` (coarse
random colour fields with finer texture and grain, so that they compress as
photographs do and not as noise) and encoded on the host in a thread pool.
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np

CHUNK = 16


def _images(g, n: int, size: int, device):
    """Each image its own contrast, brightness and share of fine texture,
    so that images differ as photographs do (a mean over part of a batch
    is not the batch's)."""
    import torch
    import torch.nn.functional as F
    coarse = torch.rand(n, 3, 8, 8, generator=g, device=device)
    fine = torch.rand(n, 3, 64, 64, generator=g, device=device)
    grain = torch.randn(n, 3, size, size, generator=g, device=device)
    look = torch.rand(3, n, 1, 1, 1, generator=g, device=device)
    contrast, level, texture = 0.2 + 0.8 * look[0], look[1], look[2] * 0.6
    x = ((1 - texture) * F.interpolate(coarse, size=size, mode="bicubic",
                                       align_corners=False)
         + texture * F.interpolate(fine, size=size, mode="bilinear",
                                   align_corners=False)
         + 0.02 * grain)
    x = (x - 0.5) * contrast + 0.3 + 0.4 * level
    x = (x.clamp(0, 1) * 255).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


WORDS = ("a", "woman", "man", "smiling", "young", "old", "with", "black",
         "blond", "brown", "gray", "hair", "wavy", "straight", "bangs",
         "wearing", "earrings", "lipstick", "eyeglasses", "hat", "she", "he",
         "has", "high", "cheekbones", "arched", "eyebrows", "mouth",
         "slightly", "open", "beard", "mustache", "pale", "skin", "and",
         "the", "is", "attractive", "oval", "face", "pointy", "nose")


def captions(seed: int, count: int, words=(5, 20)) -> List[str]:
    """Seeded captions of CelebA-HQ's attribute words, of seeded lengths."""
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[j] for j in rng.integers(
        0, len(WORDS), int(rng.integers(words[0], words[1] + 1))))
        for _ in range(count)]


def write_image_set(directory: Path, seed: int, count: int, size: int,
                    device, quality: int = 95, threads: int = 8,
                    with_captions: bool = False) -> Path:
    """`count` seeded RGB JPEGs of `size` px in `directory` and the manifest
    that lists them (`manifest.pkl`: paths, or [path, caption] entries with
    `with_captions`); returns the manifest's path. The same seed gives the
    same files."""
    import torch
    from PIL import Image
    directory.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(seed)
    paths = [str(directory / f"{i:05d}.jpg") for i in range(count)]

    def save(item):
        arr, path = item
        Image.fromarray(arr).save(path, quality=quality)

    with ThreadPoolExecutor(threads) as pool:
        for lo in range(0, count, CHUNK):
            n = min(CHUNK, count - lo)
            batch = _images(g, n, size, device)
            list(pool.map(save, zip(batch, paths[lo:lo + n])))
    entries = ([list(e) for e in zip(paths, captions(seed, count))]
               if with_captions else paths)
    manifest = directory / "manifest.pkl"
    with open(manifest, "wb") as f:
        pickle.dump(entries, f)
    return manifest


def read_manifest(path: Path) -> List[str]:
    with open(path, "rb") as f:
        return pickle.load(f)


def decode(paths: Sequence[str], resolution: int,
           threads: int = 8) -> np.ndarray:
    """The reference's view of the files: RGB, bilinear resize to
    `resolution`, scaled to [0, 1] and normalised with mean and std 0.5,
    as NHWC float32 in [-1, 1] (the transform of the published loader,
    datasets/general_dataloader.py)."""
    from PIL import Image

    def one(path):
        with Image.open(path) as img:
            img = img.convert("RGB").resize((resolution, resolution),
                                            Image.BILINEAR)
            x = np.asarray(img, np.float32) / 255.0
        return (x - 0.5) / 0.5

    with ThreadPoolExecutor(threads) as pool:
        return np.stack(list(pool.map(one, paths)))


def epoch_order(count: int, seed: int, epoch: int, shuffle: bool
                ) -> np.ndarray:
    """The order in which a shuffling loader visits the files in an epoch:
    a permutation seeded by seed + epoch (the published loader's rule, as
    the benchmark states it for its own check)."""
    idx = np.arange(count)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    return idx
