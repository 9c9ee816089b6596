"""The contrastive recipes (supcon / simclr) behind the Recipe interface,
and the MoCo-style negative queue (JAX ``recipes/supcon.py``).

Without a queue :class:`ContrastiveRecipe` delegates to the step's own
``contrastive_loss_terms``, the one the inline (``recipe=None``) path
calls, and adds no slots: ``--recipe supcon``/``simclr`` is the inline step
bit for bit, and its checkpoints keep today's keys.

``--moco_queue K`` (simclr only) makes it MoCo (He et al. 2020): the slots
hold an EMA key encoder (``recipes/base.ema_network``, momentum
``--ema_momentum``), a ``[K, feat_dim]`` queue of its past keys and the
write pointer, a host int, so reading it never waits for the device. Each
step runs a second, gradient-free forward through the key encoder; the
loss contrasts the online queries against the keys and the queue
(``ops/losses.moco_queue_loss``, the dense loss only); ``post_step`` writes
the step's detached keys at the pointer (``K`` is a multiple of ``2B``,
``config.validate_recipe``, so a write never straddles the edge), advances
the pointer and EMA-advances the key encoder. Under a process group the
keys are gathered into the global view-major order, so the queue is the
same on every process. The queue starts as L2-normalized Gaussian rows
from the recipe generator (seed + 2).

Under tensor parallelism the key encoder is sharded as the online model is
(``recipes/base.ema_network``), and its output comes back whole, so every
rank of a model group writes the same keys at the same host-int pointer:
the queue stays whole and replicated over the model group. The JAX package
shards the queue's feature axis instead; that is a layout, not a result,
and sharding it here would cost a model-group collective every step for
the same numbers. No sharding rule reads the queue (``shard_module`` walks
modules only, and a checkpoint restores it as it was saved), so the
port's dim-0 rule never splits its rows.
"""

from __future__ import annotations

import dataclasses

import torch

from simclr_pytorch_distributed_tpu_torch.ops.losses import l2_normalize, moco_queue_loss
from simclr_pytorch_distributed_tpu_torch.recipes.base import (
    Recipe,
    RecipeContext,
    ema_network,
    ema_update_,
    slow_forward,
)
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    BASE_TEMPERATURE,
    contrastive_loss_terms,
)


@dataclasses.dataclass(frozen=True)
class ContrastiveRecipe(Recipe):
    """supcon/simclr behind the interface; ``moco_queue > 0`` adds the
    momentum key encoder and the negative queue."""

    name: str = "simclr"
    moco_queue: int = 0
    feat_dim: int = 128
    # the key encoder's EMA momentum (MoCo's m; the shared --ema_momentum)
    ema_momentum: float = 0.996

    @property
    def needs_global_rows(self) -> bool:
        # without a queue the ring keeps each process's rows
        return bool(self.moco_queue)

    def init_slots(self, model, generator):
        if not self.moco_queue:
            return None, None, None
        device = next(model.parameters()).device
        queue = l2_normalize(torch.randn(self.moco_queue, self.feat_dim, generator=generator))
        return None, None, {"queue_emb": queue.to(device), "queue_ptr": 0,
                            "key": ema_network(model)}

    def loss(self, cfg, ctx: RecipeContext):
        if cfg.method not in ("SupCon", "SimCLR"):
            raise ValueError(f"contrastive method not supported: {cfg.method}")
        loss_labels = ctx.labels if cfg.method == "SupCon" else None
        if not self.moco_queue:
            return contrastive_loss_terms(cfg, ctx.n_fea, loss_labels), {}
        if cfg.loss_impl != "dense":
            # the fused/ring kernels tile the fixed 2B x 2B geometry; the
            # queue extends the contrast side to 2B + K
            raise ValueError(f"--moco_queue needs loss_impl='dense', got {cfg.loss_impl!r}")
        # keys: the key encoder's rows, normalized and detached (keys never
        # backpropagate)
        keys = l2_normalize(slow_forward(ctx.recipe_state["key"], ctx.images))
        loss = moco_queue_loss(ctx.n_fea, keys, ctx.recipe_state["queue_emb"],
                               temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE)
        return loss, {"recipe_embeddings": keys}

    def post_step(self, recipe_state, *, model, aux):
        if not self.moco_queue:
            return recipe_state
        keys = aux["recipe_embeddings"]  # [2B, D]
        ptr = recipe_state["queue_ptr"]
        with torch.no_grad():
            recipe_state["queue_emb"][ptr:ptr + keys.shape[0]] = keys
        recipe_state["queue_ptr"] = (ptr + keys.shape[0]) % self.moco_queue
        ema_update_(recipe_state["key"], model, self.ema_momentum)
        return recipe_state
