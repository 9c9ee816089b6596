"""Learning-rate schedules with the reference's semantics (``util.py:54-76``),
as plain Python floats of the 0-based global step.

- Per-epoch base schedule: cosine with ``eta_min = lr * lr_decay_rate**3``,
  or step decay counting the boundaries already passed; epoch is 1-based.
- Per-iteration linear warmup ``warmup_from -> warmup_to`` that overrides
  the base schedule during the first ``warm_epochs`` epochs, where
  ``warmup_to`` is the closed-form cosine value at the end of warmup
  (``main_supcon.py:124-131``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def warmup_to_value(
    lr: float, lr_decay_rate: float, warm_epochs: int, total_epochs: int, cosine: bool
) -> float:
    """Closed-form warmup target (``main_supcon.py:124-131``)."""
    if cosine:
        eta_min = lr * (lr_decay_rate**3)
        return eta_min + (lr - eta_min) * (
            1 + math.cos(math.pi * warm_epochs / total_epochs)
        ) / 2
    return lr


def make_lr_schedule(
    *,
    learning_rate: float,
    epochs: int,
    steps_per_epoch: int,
    cosine: bool = False,
    lr_decay_rate: float = 0.1,
    lr_decay_epochs: Sequence[int] = (700, 800, 900),
    warm: bool = False,
    warm_epochs: int = 10,
    warmup_from: float = 0.01,
) -> Callable[[int], float]:
    """``lr(step)`` for the 0-based global step: ``epoch = step //
    steps_per_epoch + 1`` recovers the reference's loop variable."""
    lr_decay_epochs = tuple(lr_decay_epochs)
    warmup_to = warmup_to_value(learning_rate, lr_decay_rate, warm_epochs, epochs, cosine)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        if warm and epoch <= warm_epochs:
            p = step / (warm_epochs * steps_per_epoch)
            return warmup_from + p * (warmup_to - warmup_from)
        if cosine:
            eta_min = learning_rate * (lr_decay_rate**3)
            return eta_min + (learning_rate - eta_min) * (
                1.0 + math.cos(math.pi * epoch / epochs)
            ) / 2.0
        passed = sum(1 for b in lr_decay_epochs if epoch > b)
        return learning_rate * (lr_decay_rate**passed)

    return schedule
