"""The Recipe protocol (JAX ``recipes/base.py``): what a self-supervised
loss head provides to ride the pretraining step.

A recipe is a frozen object the train step (``train/supcon_step.py``)
reads from ``TrainState.recipe``. It contributes:

- ``loss(cfg, ctx)``: the step's loss term from the step's own forward
  products (a :class:`RecipeContext`), and an aux dict: entries named in
  ``metric_keys`` stream through the metric ring, and the reserved
  ``"recipe_embeddings"`` entry is the detached payload ``post_step``
  writes into the queue;
- trainable state: a ``trainable`` recipe's predictor is
  ``TrainState.recipe_params``, differentiated in the same backward as the
  encoder (its gradient reaches the backbone) and stepped by its own
  optimizer, ``TrainState.recipe_opt_state``;
- ``post_step(recipe_state, model=, aux=)``: the non-gradient transition
  after the optimizer step (BYOL's EMA target, the MoCo queue and key
  encoder), applied to ``TrainState.recipe_state``.

``init_slots(model, generator)`` builds the initial ``(recipe_params,
recipe_opt_state, recipe_state)``; all ``None`` (the contrastive recipes
without a queue) keeps the state and its checkpoints exactly today's. The
non-``None`` slots are checkpointed as the ``recipe`` payload
(``utils/checkpoint.py``) with the recipe's name and queue geometry, so a
resume under another recipe starts the slots fresh, loudly.

The EMA networks (:func:`ema_network`) are fresh ``SupConResNet`` modules
with the online model's conv path, compute dtype and BN process group,
loaded from its state dict: their train-mode forward normalizes with batch
statistics and updates their own BN buffers, which nothing reads, so the
online model's buffers never move with the second forward (JAX discards
that forward's batch-statistics mutation). Only their parameters are
checkpointed, as in the JAX package.

Under tensor parallelism (``--model_parallel N``) the online model holds
its model index's shards (``parallel/mesh.shard_module``), and so does
every network built beside it (:func:`shard_like`): an EMA network is
built whole, sharded as the online model is, then loaded, so it carries
the same shard marks and its forward takes the same model-group
collectives; the predictor is drawn whole from the slot generator (every
rank draws the same values, the init of one process), then sharded before
its optimizer is built. The EMA update is elementwise, so it runs shard by
shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from simclr_pytorch_distributed_tpu_torch.parallel import mesh
# re-exported: the context lives beside the step that builds it, so the
# step never imports recipes/
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (  # noqa: F401
    RecipeContext,
    global_rows,
    two_view_forward,
)

RecipeSlots = Tuple[Any, Any, Any]  # (recipe_params, recipe_opt_state, recipe_state)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """No slots, no extra metrics, no post-step. ``make_optimizer`` builds
    a trainable recipe's predictor optimizer from its module
    (``recipes.build_recipe``: the encoder's chain and hyperparameters)."""

    name: str = "recipe"
    # True: state.recipe_params exists and trains with the encoder
    trainable: bool = False
    # the extra metric-ring columns this recipe streams
    metric_keys: Tuple[str, ...] = ()
    make_optimizer: Optional[Callable[[nn.Module], torch.optim.Optimizer]] = None

    @property
    def needs_global_rows(self) -> bool:
        """Whether the loss reads the global batch's rows under a process
        group, so the step gathers them even under ``--loss_impl ring``
        (which otherwise keeps each process's own rows)."""
        return True

    def init_slots(self, model: nn.Module, generator: torch.Generator) -> RecipeSlots:
        return None, None, None

    def loss(self, cfg, ctx: RecipeContext):
        """``(loss_term, aux)`` for one step."""
        raise NotImplementedError

    def post_step(self, recipe_state, *, model: nn.Module, aux: dict):
        """The transition after the optimizer step; called only when
        ``recipe_state`` is not None."""
        return recipe_state


def shard_like(module: nn.Module, model: nn.Module) -> nn.Module:
    """``module`` (whole) sharded in place as ``model`` is: over its model
    group's ``N`` at its model index (``model.tp_shard``, which
    ``parallel/mesh.shard_module`` sets); nothing changes for an unsharded
    ``model``. Returns ``module``."""
    model_size, index = getattr(model, "tp_shard", (1, 0))
    if model_size > 1:
        mesh.shard_module(module, model_size, index)
    return module


def ema_network(model: nn.Module) -> nn.Module:
    """A second ``SupConResNet`` equal to ``model``: built fresh (never a
    deep copy of a module that may hold a process group) with its conv
    path, compute dtype and BN group, on its device in its parameter dtype,
    sharded as ``model`` is (:func:`shard_like`), loaded from its state
    dict, frozen (no gradient) and in train mode. The global generator is
    left as it was."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet

    device, dtype = next(model.parameters()).device, next(model.parameters()).dtype
    with torch.random.fork_rng(devices=[]):
        net = SupConResNet(*model.arch)
    enc = model.encoder
    net.encoder.set_conv_impl(enc.conv_impl).set_compute_dtype(enc.compute_dtype)
    net.encoder.set_bn_sync(enc.bn_group)
    net = net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    shard_like(net, model)
    net.load_state_dict(model.state_dict())
    net.requires_grad_(False)
    return net.train()


@torch.no_grad()
def ema_update_(slow: nn.Module, model: nn.Module, momentum: float) -> None:
    """``slow = momentum * slow + (1 - momentum) * online`` over the
    parameters, in fp32 (JAX's ``tau * t + (1 - tau) * o``, each product
    rounded before the sum)."""
    slow_params = list(slow.parameters())
    torch._foreach_mul_(slow_params, momentum)
    torch._foreach_add_(slow_params, torch._foreach_mul(
        [p.detach() for p in model.parameters()], 1.0 - momentum))


@torch.no_grad()
def slow_forward(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The EMA network's train-mode forward of both views, without
    gradient: the global batch's view-major fp32 rows (gathered under a
    process group)."""
    net.train()
    return global_rows(two_view_forward(net, images).to(torch.float32))
