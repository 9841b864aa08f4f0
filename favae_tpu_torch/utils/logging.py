"""Metrics: TensorBoard scalars and image grids (port of
favae_tpu/utils/logging.py; reference: favae_scripts/train_favae.py:121-177,
utils.py:122-124).

The writer is `torch.utils.tensorboard.SummaryWriter`, in TensorBoard's
TensorFlow-free mode. Where a `log_dir` is given and tensorboard does not
import, the writer says so in one line and records nothing. In a run of
several processes `print0` prints on rank 0 only, and the trainers give
the writer a `log_dir` on rank 0 only.
"""

from __future__ import annotations

import sys
import types
from typing import Dict, Optional

import numpy as np
import torch

from favae_tpu_torch.parallel.mesh import is_main_process


def print0(*args, **kwargs):
    if is_main_process():
        print(*args, **kwargs, flush=True)


def _host(x) -> np.ndarray:
    """NHWC images as a float numpy array (tensors fetched from the device
    here, so nothing is fetched when no writer records them)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class MetricWriter:
    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir:
            # without this marker module TensorBoard imports TensorFlow
            # where it is installed (~10 s and ~1 GB), for event files it
            # writes as well without
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print0(f"tensorboard does not import ({e}): no metrics or "
                       f"images are written to {log_dir}")
            else:
                self._writer = SummaryWriter(log_dir)

    def scalars(self, prefix: str, metrics: Dict[str, float], step: int):
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass
        self._writer.flush()

    def recon_grid(self, name: str, x, x_recon, step: int):
        """[x; x_recon] grid, denormalised from [-1, 1]
        (reference: train_favae.py:42-53). NHWC float."""
        if self._writer is None:
            return
        img = np.concatenate([_host(x), _host(x_recon)], axis=0)
        img = np.clip(img * 0.5 + 0.5, 0.0, 1.0)
        n, h, w, c = img.shape
        cols = max(1, n // 2)
        rows = -(-n // cols)
        grid = np.zeros((rows * h, cols * w, c), img.dtype)
        for i in range(n):
            r, col = divmod(i, cols)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img[i]
        self._writer.add_image(name, grid, step, dataformats="HWC")
        self._writer.flush()

    def caption_grid(self, name: str, x, samples, captions, step: int):
        """One column a sample: [input; generated] with the caption drawn
        underneath with PIL (reference: cat_scripts/train_cat.py:44-66 draws
        them as matplotlib titles); a bare grid without PIL."""
        if self._writer is None:
            return
        x = np.clip(_host(x) * 0.5 + 0.5, 0.0, 1.0)
        samples = np.clip(_host(samples) * 0.5 + 0.5, 0.0, 1.0)
        n, h, w, c = x.shape
        try:
            from textwrap import wrap

            from PIL import Image, ImageDraw
        except ImportError:
            out = np.concatenate([np.concatenate(list(x), axis=1),
                                  np.concatenate(list(samples), axis=1)],
                                 axis=0)
        else:
            line_h, pad = 12, 4
            wrapped = [wrap(str(cap), max(8, w // 7))[:4] or [""]
                       for cap in captions[:n]]
            strip_h = pad * 2 + line_h * max(len(ls) for ls in wrapped)
            grid = np.zeros((2 * h + strip_h, n * w, c), np.float32)
            for i in range(n):
                grid[:h, i * w:(i + 1) * w] = x[i]
                grid[h:2 * h, i * w:(i + 1) * w] = samples[i]
            img = Image.fromarray((grid * 255).astype(np.uint8))
            draw = ImageDraw.Draw(img)
            for i, lines in enumerate(wrapped):
                for j, line in enumerate(lines):
                    draw.text((i * w + 2, 2 * h + pad + j * line_h), line,
                              fill=(255, 255, 255))
            out = np.asarray(img, np.float32) / 255.0
        self._writer.add_image(name, out, step, dataformats="HWC")
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


def device_memory_mib(device=None) -> float:
    """Peak device memory reserved, in MiB (the reference logs
    torch.cuda.max_memory_reserved, train_favae.py:122); 0 on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_reserved(dev) / (1 << 20)
