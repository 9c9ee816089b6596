"""BYOL (Grill et al. 2020): a predictor and an EMA target network (JAX
``recipes/byol.py``).

The online branch is the step's own encoder and projector forward; the
predictor (``models/heads.PredictorHead``) is ``recipe_params``, trained in
the same backward (BYOL's encoder is reached only through it), and the
target, a full copy of the online network (``recipes/base.ema_network``),
is ``recipe_state["target"]``, moved after each optimizer step by
``target = tau * target + (1 - tau) * online``. The target's forward runs
in train mode (batch statistics, as the online branch) under
``torch.no_grad``; its BN buffers are its own and unread, so it is the
EMA of the parameters only. ``--byol_predictor none`` removes the
predictor (``trainable`` False): the known-collapsing ablation that the
raised collapse bars (``utils/guard.RECIPE_HEALTH_THRESHOLDS``) exist to
catch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from simclr_pytorch_distributed_tpu_torch.models.heads import PredictorHead
from simclr_pytorch_distributed_tpu_torch.ops.losses import byol_loss
from simclr_pytorch_distributed_tpu_torch.recipes.base import (
    Recipe,
    RecipeContext,
    ema_network,
    ema_update_,
    shard_like,
    slow_forward,
)


@dataclasses.dataclass(frozen=True)
class BYOLRecipe(Recipe):
    name: str = "byol"
    # the predictor's hidden width; None ablates the predictor
    predictor_hidden: Optional[int] = 512
    feat_dim: int = 128
    ema_momentum: float = 0.996

    def __post_init__(self):
        object.__setattr__(self, "trainable", self.predictor_hidden is not None)

    def init_slots(self, model, generator):
        predictor = optimizer = None
        if self.predictor_hidden is not None:
            device = next(model.parameters()).device
            with torch.random.fork_rng(devices=[]):
                predictor = PredictorHead(self.predictor_hidden, self.feat_dim,
                                          generator=generator).to(device)
            shard_like(predictor, model)
            optimizer = self.make_optimizer(predictor)
        return predictor, optimizer, {"target": ema_network(model)}

    def loss(self, cfg, ctx: RecipeContext):
        q = ctx.feats if ctx.recipe_params is None else ctx.recipe_params(ctx.feats)
        target = slow_forward(ctx.recipe_state["target"], ctx.images)
        return byol_loss(q, target), {}

    def post_step(self, recipe_state, *, model, aux):
        ema_update_(recipe_state["target"], model, self.ema_momentum)
        return recipe_state
