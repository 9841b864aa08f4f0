"""Frozen copy of the port's `train/schedule.py` with its plain paths only, the
benchmark's reference (imports nothing of the port; see ../README.md).

Learning-rate schedules (port of favae_tpu/train/schedule.py).

reference: utils.py:40-65 CosineLRWarmUp: a linear warm-up over
`warmup_epochs`, then a half cosine down to `min_lr`; the CAT trainer steps
it fractionally, scheduler.step(epoch + step / steps_per_epoch)
(cat_scripts/train_cat.py:78). `make_step_schedule` gives the lr of update
i (0-based, the first warm-up update has lr 0) in f32, in the JAX
package's order of f32 operations, so the two agree to the last bits.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def make_step_schedule(steps_per_epoch: int, *, warmup_epochs: float,
                       epochs: float, lr: float, min_lr: float = 0.0,
                       enabled: bool = True) -> Callable[[int], float]:
    """Update index -> lr, the f32 value of favae_tpu's optax schedule: the
    same f32 operations in the same order, the cosine rounded from f64."""
    f32 = np.float32

    def sched(step: int) -> float:
        if not enabled:
            return float(f32(lr))
        frac = f32(step) / f32(steps_per_epoch)
        if frac < warmup_epochs:
            return float(f32(lr) * frac / f32(max(warmup_epochs, 1e-8)))
        angle = f32(math.pi) * (frac - f32(warmup_epochs)) / f32(
            epochs - warmup_epochs)
        cos = f32(math.cos(angle))
        return float(f32(min_lr) + f32((lr - min_lr) * 0.5) * (f32(1) + cos))

    return sched
