"""SimSiam (Chen & He 2021): a predictor and a stop-gradient, no EMA (JAX
``recipes/simsiam.py``).

One branch: the predictor is ``recipe_params``, trained in the step's
backward, and the stop-gradient on the projection side is applied inside
``ops/losses.simsiam_loss``. No target network, no ``recipe_state``.
"""

from __future__ import annotations

import dataclasses

import torch

from simclr_pytorch_distributed_tpu_torch.models.heads import PredictorHead
from simclr_pytorch_distributed_tpu_torch.ops.losses import simsiam_loss
from simclr_pytorch_distributed_tpu_torch.recipes.base import Recipe, RecipeContext, shard_like


@dataclasses.dataclass(frozen=True)
class SimSiamRecipe(Recipe):
    name: str = "simsiam"
    trainable: bool = True
    predictor_hidden: int = 512
    feat_dim: int = 128

    def init_slots(self, model, generator):
        device = next(model.parameters()).device
        with torch.random.fork_rng(devices=[]):
            predictor = PredictorHead(self.predictor_hidden, self.feat_dim,
                                      generator=generator).to(device)
        shard_like(predictor, model)
        return predictor, self.make_optimizer(predictor), None

    def loss(self, cfg, ctx: RecipeContext):
        return simsiam_loss(ctx.recipe_params(ctx.feats), ctx.feats), {}
