"""Precomputed-latent cache for CAT training (port of
favae_tpu/data/latent_cache.py).

The CAT hot loop runs two frozen towers on every batch of every epoch: the
FA-VAE encoder and quantizer at 256 px and the CLIP text encoder
(reference: cat_scripts/train_cat.py:69-109 -> models/
txt_cond_transformer.py:134-150). Both are deterministic functions of the
sample, so `precompute_latents` runs them once over a caption dataset, in
one unshuffled pass that drops nothing, and returns a `LatentDataset`
indexed by the dataset's own index: a DataLoader over it with the same
seed replays the image loader's batch order, so training from the cache
takes the full pipeline's updates.

Host memory a sample: L*8 (z ids) + 77*D*4 (f32 CLIP token embeds) + 77*8
(text ids) + 77 (mask) bytes, ~237 KB for ViT-L/14 (D 768).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from favae_tpu_torch.data.pipeline import DataLoader


class LatentDataset:
    """Items `(z, embeds, mask, text_ids, caption)`: what a latent train or
    eval step needs, and the caption. Works with
    `favae_tpu_torch.data.pipeline.DataLoader`."""

    def __init__(self, z: np.ndarray, embeds: np.ndarray, mask: np.ndarray,
                 text_ids: np.ndarray, captions: list):
        n = len(z)
        assert len(embeds) == len(mask) == len(text_ids) == len(captions) == n
        self.z, self.embeds, self.mask = z, embeds, mask
        self.text_ids, self.captions = text_ids, captions

    def __len__(self):
        return len(self.z)

    def get(self, index: int):
        return (self.z[index], self.embeds[index], self.mask[index],
                self.text_ids[index], self.captions[index])

    def nbytes(self) -> int:
        return (self.z.nbytes + self.embeds.nbytes + self.mask.nbytes
                + self.text_ids.nbytes)


def precompute_latents(cat, dataset, batch_size: int, num_workers: int = 4,
                       log: Callable = lambda m: None) -> LatentDataset:
    """One pass of the frozen towers of `cat` (a `CATModel`, on its device)
    over a caption dataset, items `(x, caption)` -> `LatentDataset`. Entry
    i of the cache is sample i; the last partial batch is padded to
    `batch_size` with copies of its last sample, so every encode sees the
    same batch shape, and trimmed."""
    loader = DataLoader(dataset, batch_size, num_workers=num_workers,
                        shuffle=False, drop_last=False)
    zs, es, ms, tids, captions = [], [], [], [], []
    done = 0
    for x, caps in loader:
        ids = cat.tokenize(list(caps))
        n = x.shape[0]
        x = torch.from_numpy(x).to(cat.device)
        if n < batch_size:
            pad = batch_size - n
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            ids = torch.cat([ids, ids[-1:].expand(pad, -1)])
        z = cat.encode_to_z(x)
        embeds, mask = cat.encode_text_ids(ids)
        zs.append(z[:n].cpu().numpy())
        es.append(embeds[:n].cpu().numpy())
        ms.append(mask[:n].cpu().numpy())
        tids.append(ids[:n].cpu().numpy())
        captions.extend(caps)
        done += n
        log(f"cached latents {done}/{len(dataset)}")
    out = LatentDataset(np.concatenate(zs), np.concatenate(es),
                        np.concatenate(ms), np.concatenate(tids), captions)
    log(f"latent cache: {len(out)} samples, "
        f"{out.nbytes() / 1e6:.0f} MB host RAM")
    return out
