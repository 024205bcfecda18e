"""Learning-rate schedules (port of ``pvraft_tpu/engine/schedule.py``).

The reference constructs ``CosineAnnealingLR(T_max=num_epochs *
len(train_dataset))`` but steps it once per epoch, so the cosine argument
only reaches ``num_epochs / (num_epochs * dataset_len)``: an effectively
constant LR. ``parity`` reproduces that exactly; ``cosine`` is the
corrected per-step decay; ``constant`` is constant.

The schedule is a function of the optimizer step. As optax evaluates it
at the count *before* that step's increment, step 0 takes lr(0): the
train step sets ``lr(step)`` and then takes the step.
"""

from __future__ import annotations

import math
from typing import Callable


def make_lr_schedule(kind: str, base_lr: float, num_epochs: int,
                     steps_per_epoch: int, dataset_len: int
                     ) -> Callable[[int], float]:
    """Returns lr(step), step = optimizer steps taken before this one."""
    if kind == "parity":
        t_max = float(num_epochs * dataset_len)

        def schedule(step: int) -> float:
            epoch = step // max(1, steps_per_epoch)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / t_max))

        return schedule
    if kind == "cosine":
        total = max(1, num_epochs * steps_per_epoch)

        def schedule(step: int) -> float:
            frac = min(max(step / total, 0.0), 1.0)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return schedule
    if kind == "constant":
        return lambda step: base_lr
    raise ValueError(f"unknown lr schedule {kind!r}")
