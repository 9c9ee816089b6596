"""VICReg (Bardes et al. 2022): invariance, variance and covariance (JAX
``recipes/vicreg.py``).

No predictor, no EMA, no negatives: the variance hinge in the loss keeps
the embeddings apart. The three unweighted terms stream through the metric
ring as ``vicreg_cov``, ``vicreg_inv`` and ``vicreg_var``.
"""

from __future__ import annotations

import dataclasses

from simclr_pytorch_distributed_tpu_torch.ops.losses import vicreg_loss
from simclr_pytorch_distributed_tpu_torch.recipes.base import Recipe, RecipeContext

VICREG_METRIC_KEYS = ("vicreg_cov", "vicreg_inv", "vicreg_var")


@dataclasses.dataclass(frozen=True)
class VICRegRecipe(Recipe):
    name: str = "vicreg"
    sim_coeff: float = 25.0
    std_coeff: float = 25.0
    cov_coeff: float = 1.0
    metric_keys: tuple = VICREG_METRIC_KEYS

    def loss(self, cfg, ctx: RecipeContext):
        b = ctx.feats.shape[0] // 2
        return vicreg_loss(ctx.feats[:b], ctx.feats[b:], sim_coeff=self.sim_coeff,
                           std_coeff=self.std_coeff, cov_coeff=self.cov_coeff)
