"""Learning-rate schedules: port of ``cnsn_tpu/train/schedules.py``.

Each returns a plain function of the 0-based update count s: update s
runs at lr = schedule(s), as optax counts.
  * per-step cosine annealing to an absolute floor of 1e-6;
  * ImageNet step decay ÷10 at epochs//3 and 2·epochs//3 with linear
    batch-size scaling;
  * polynomial decay and ÷10 step decay for segmentation.
"""
from __future__ import annotations

import math
from typing import Callable

__all__ = ["cosine_lr", "imagenet_step_lr", "poly_lr", "step_lr"]

Schedule = Callable[[int], float]


def cosine_lr(base_lr: float, total_steps: int,
              lr_min: float = 1e-6) -> Schedule:
    """lr(s) = base·(f + (1−f)·(1 + cos(π s/total))/2) with f = lr_min/base:
    the reference's LambdaLR(get_lr(step, total, 1, 1e-6/base))·base."""
    frac = lr_min / base_lr

    def schedule(step: int) -> float:
        return base_lr * (frac + (1.0 - frac) * 0.5 * (
            1.0 + math.cos(step / total_steps * math.pi)))

    return schedule


def imagenet_step_lr(base_lr: float, epochs: int, batch_size: int,
                     steps_per_epoch: int) -> Schedule:
    """÷10 at epochs//3 and 2·epochs//3 (a three-level staircase, as the
    reference caps it), lr scaled by batch/256."""
    b = batch_size / 256.0
    k = max(epochs // 3, 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * b * 0.1 ** min(epoch // k, 2)

    return schedule


def poly_lr(base_lr: float, max_iter: int, power: float = 0.9) -> Schedule:
    """Per-iteration poly decay; update s runs at poly(s), poly(0) = base."""

    def schedule(step: int) -> float:
        return base_lr * (1.0 - step / max_iter) ** power

    return schedule


def step_lr(base_lr: float, step_epoch: int, steps_per_epoch: int,
            multiplier: float = 0.1) -> Schedule:
    """÷10 (``multiplier``) every ``step_epoch`` epochs."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * multiplier ** (epoch // step_epoch)

    return schedule
