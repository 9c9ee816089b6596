"""Training state and the reference's SGD optimizer.

``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)`` over
ALL parameters (reference ``util.py:79-84``: BN weight and bias are decayed
too) applies ``d = g + wd*p; buf = mu*buf + d; p -= lr*buf`` with
``buf = d`` on the first step, which is the JAX package's
``add_decayed_weights -> trace -> scale_by_learning_rate`` chain step for
step. The learning rate is set before every step from the schedule at the
state's step count.

Under data parallelism every process holds its own state: the driver
starts them all from rank 0's weights (``train/supcon.build``), SGD is
unchanged and sees the gradient averaged over the processes
(``parallel/collectives.mean_gradients``), so the states stay equal and a
checkpoint is rank 0's model itself, in the reference layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn


def make_optimizer(
    model: nn.Module, momentum: float = 0.9, weight_decay: float = 1e-4
) -> torch.optim.SGD:
    """SGD over every parameter; the learning rate is set per step."""
    return torch.optim.SGD(
        model.parameters(), lr=0.0, momentum=momentum, dampening=0.0,
        weight_decay=weight_decay, nesterov=False,
    )


@dataclasses.dataclass
class TrainState:
    """What one run carries from step to step.

    ``step`` is the 0-based global iteration (a host int, so reading it never
    waits for the device); ``record_norm_mean`` is the SEC feature-norm EMA
    (reference ``opt.record_norm_mean``, ``main_supcon.py:304-307``), kept
    on the device as a 0-dim tensor.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    record_norm_mean: Optional[torch.Tensor] = None

    def set_learning_rate(self) -> float:
        lr = float(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr
