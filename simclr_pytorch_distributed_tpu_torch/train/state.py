"""Training state, the reference's SGD optimizer and LARS.

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

``--optimizer lars`` (:class:`LARS`) is the JAX package's large-batch
choice (``train/state.py:60-97``, ``optax.lars``), chain for chain:

- ``u = g + wd * p`` on kernels only (``ndim > 1``);
- ``u *= trust`` on kernels only, ``trust = 0.001 * |p| / |u|``, and 1
  where either norm is 0;
- ``u *= lr`` (the schedule at the step count);
- ``buf = mu * buf + u``, ``buf`` starting at zero;
- ``p -= buf`` (no Nesterov).

Momentum comes after the learning rate here, unlike ``torch.optim.SGD``,
and biases and BN scales and shifts (1-D) get neither weight decay nor the
trust ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn


# optax.lars's default trust coefficient
LARS_TRUST_COEFFICIENT = 1e-3


class LARS(torch.optim.Optimizer):
    """``optax.lars`` with the JAX package's masks (module docstring): weight
    decay and the trust ratio on kernels only. Its state per parameter is
    ``momentum_buffer``, as SGD's, so a state dict round-trips through
    ``--resume``."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if p.ndim > 1:
                    u = u + group["weight_decay"] * p
                    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                    trust = LARS_TRUST_COEFFICIENT * p_norm / u_norm
                    u = u * torch.where((p_norm == 0) | (u_norm == 0), 1.0, trust)
                u = u * group["lr"]
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(group["momentum"]).add_(u)
                p.sub_(buf)


def make_optimizer(
    model: nn.Module, momentum: float = 0.9, weight_decay: float = 1e-4,
    optimizer: str = "sgd",
) -> torch.optim.Optimizer:
    """SGD over every parameter (the reference's), or :class:`LARS`; the
    learning rate is set per step."""
    if optimizer == "lars":
        return LARS(model.parameters(), momentum=momentum, weight_decay=weight_decay)
    if optimizer != "sgd":
        raise ValueError(f"optimizer must be 'sgd' or 'lars', got {optimizer!r}")
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
    on the device as a 0-dim tensor. ``lr_scale`` multiplies the schedule:
    the NaN rollback's damping (``utils/guard.FailurePolicy``).
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    record_norm_mean: Optional[torch.Tensor] = None
    lr_scale: float = 1.0

    def set_learning_rate(self) -> float:
        lr = float(self.schedule(self.step)) * self.lr_scale
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr
