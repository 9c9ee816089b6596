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

Tensor parallelism (``--model_parallel N``): the model's sharded
parameters are its model index's slices (``parallel/mesh.shard_module``),
so either optimizer's momentum buffers are the same slices of the
replicated run's. SGD is elementwise and needs nothing more. LARS's trust
ratio reads the norms of whole leaves: given the ``model_group``, the
squared norms of the sharded kernels (and of their updates) are summed over
it, one all-reduce a step, while a replicated kernel keeps its own norm.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from simclr_pytorch_distributed_tpu_torch.parallel.mesh import whole_norms


# optax.lars's default trust coefficient
LARS_TRUST_COEFFICIENT = 1e-3


class LARS(torch.optim.Optimizer):
    """``optax.lars`` with the JAX package's masks (module docstring): weight
    decay and the trust ratio on kernels only. Its state per parameter is
    ``momentum_buffer``, as SGD's, so a state dict round-trips through
    ``--resume``."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 weight_decay: float = 1e-4, model_group=None):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))
        self.model_group = model_group

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if "momentum_buffer" not in self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            # each chain step over all parameters at once, a few launches
            # each: a loop over the parameters launched ~2000 small kernels
            # a ResNet-50 step and held the host back (PERF.md §6)
            kernels = [p for p in params if p.ndim > 1]
            u_k = []
            if kernels:
                u_k = torch._foreach_add([p.grad for p in kernels], kernels,
                                         alpha=group["weight_decay"])
                p_norm = torch.stack(torch._foreach_norm(kernels))
                u_norm = torch.stack(torch._foreach_norm(u_k))
                if self.model_group is not None:
                    p_norm, u_norm = whole_norms(torch.stack([p_norm, u_norm]), kernels,
                                                 self.model_group).unbind()
                trust = LARS_TRUST_COEFFICIENT * p_norm / u_norm
                trust = torch.where((p_norm == 0) | (u_norm == 0), 1.0, trust)
                torch._foreach_mul_(u_k, list(trust.unbind()))
            u_k = iter(u_k)
            u = [next(u_k) if p.ndim > 1 else p.grad for p in params]
            u = torch._foreach_mul(u, group["lr"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, u)
            torch._foreach_sub_(params, bufs)


def make_optimizer(
    model: nn.Module, momentum: float = 0.9, weight_decay: float = 1e-4,
    optimizer: str = "sgd", model_group=None,
) -> torch.optim.Optimizer:
    """SGD over every parameter (the reference's), or :class:`LARS`; the
    learning rate is set per step. ``model_group``: the tensor-parallel
    group whose shards LARS's norms sum over (``None`` without one)."""
    if optimizer == "lars":
        return LARS(model.parameters(), momentum=momentum, weight_decay=weight_decay,
                    model_group=model_group)
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

    ``recipe`` is the run's SSL recipe (``recipes/``; ``None`` keeps the
    step's inline contrastive path) and the three recipe slots are JAX's
    (``train/state.py:43-57``): ``recipe_params`` the trainable predictor
    (an ``nn.Module``), ``recipe_opt_state`` its optimizer, and
    ``recipe_state`` the non-gradient state (BYOL's EMA target network; the
    MoCo key encoder, queue and pointer), each ``None`` where the recipe
    has none, so a slot-free recipe's state and checkpoints are today's.
    """

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    record_norm_mean: Optional[torch.Tensor] = None
    lr_scale: float = 1.0
    probe: Optional[object] = None
    recipe: Optional[object] = None
    recipe_params: Optional[nn.Module] = None
    recipe_opt_state: Optional[torch.optim.Optimizer] = None
    recipe_state: Optional[dict] = None

    def set_learning_rate(self) -> float:
        lr = float(self.schedule(self.step)) * self.lr_scale
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr
