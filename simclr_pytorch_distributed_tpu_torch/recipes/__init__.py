"""recipes/: the SSL recipes behind ``--recipe`` (JAX ``recipes/``).

- ``supcon`` / ``simclr``: the contrastive step behind the interface
  (:class:`ContrastiveRecipe`, the inline step bit for bit), optionally
  with the MoCo-style negative queue (``--moco_queue``);
- ``byol``: a predictor and an EMA target network;
- ``simsiam``: a predictor and a stop-gradient;
- ``vicreg``: invariance, variance and covariance.

:func:`build_recipe` turns a finalized ``SupConConfig`` into the recipe;
:func:`attach_recipe_slots` installs its initial slots on a ``TrainState``
(nothing for the slot-free recipes); :func:`attach_for_config` does both
and puts the recipe on the state, where the train step reads it.
"""

from __future__ import annotations

import functools

import torch

from simclr_pytorch_distributed_tpu_torch.recipes.base import (  # noqa: F401
    Recipe,
    RecipeContext,
)
from simclr_pytorch_distributed_tpu_torch.recipes.byol import BYOLRecipe
from simclr_pytorch_distributed_tpu_torch.recipes.simsiam import SimSiamRecipe
from simclr_pytorch_distributed_tpu_torch.recipes.supcon import ContrastiveRecipe
from simclr_pytorch_distributed_tpu_torch.recipes.vicreg import VICRegRecipe

# the --recipe surface ('auto' resolves to the --method-matching
# contrastive recipe in config.validate_recipe)
RECIPE_NAMES = ("supcon", "simclr", "byol", "simsiam", "vicreg")

# name -> class: where metric-key knowledge is looked up by name
_RECIPE_CLASSES = {
    "supcon": ContrastiveRecipe,
    "simclr": ContrastiveRecipe,
    "byol": BYOLRecipe,
    "simsiam": SimSiamRecipe,
    "vicreg": VICRegRecipe,
}


def recipe_metric_keys(name) -> tuple:
    """The extra ring columns recipe ``name`` streams, read off its class
    (``()`` for an unknown name or ``None``)."""
    cls = _RECIPE_CLASSES.get(name)
    return tuple(cls.metric_keys) if cls is not None else ()


# every recipe metric key any recipe can stream (the TensorBoard tag map)
ALL_RECIPE_METRIC_KEYS = tuple(sorted(
    set().union(*(recipe_metric_keys(n) for n in RECIPE_NAMES))
))


def build_recipe(cfg) -> Recipe:
    """The recipe of a finalized ``SupConConfig``. A trainable recipe's
    predictor optimizer is ``train/state.make_optimizer``: the encoder's
    momentum, weight decay and ``sgd``/``lars``, its learning rate set each
    step from the run's schedule (``train/supcon_step.py``), and the
    encoder's model group, over which LARS sums a sharded predictor leaf's
    norms (``None`` without a grid)."""
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    from simclr_pytorch_distributed_tpu_torch.train.state import make_optimizer

    name = cfg.recipe
    if name not in RECIPE_NAMES:
        raise ValueError(f"unknown recipe {name!r} (choose from {RECIPE_NAMES}; was "
                         "config.finalize_supcon run?)")
    if name in ("supcon", "simclr"):
        return ContrastiveRecipe(name=name, moco_queue=cfg.moco_queue, feat_dim=cfg.feat_dim,
                                 ema_momentum=cfg.ema_momentum)
    if name == "vicreg":
        return VICRegRecipe(sim_coeff=cfg.vicreg_sim_coeff, std_coeff=cfg.vicreg_std_coeff,
                            cov_coeff=cfg.vicreg_cov_coeff)
    predictor_optimizer = functools.partial(
        make_optimizer, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        optimizer=cfg.optimizer, model_group=mesh.model_group())
    if name == "byol":
        ablated = cfg.byol_predictor == "none"
        return BYOLRecipe(predictor_hidden=None if ablated else cfg.predictor_hidden,
                          feat_dim=cfg.feat_dim, ema_momentum=cfg.ema_momentum,
                          make_optimizer=None if ablated else predictor_optimizer)
    return SimSiamRecipe(predictor_hidden=cfg.predictor_hidden, feat_dim=cfg.feat_dim,
                         make_optimizer=predictor_optimizer)


def attach_recipe_slots(recipe: Recipe, state, generator: torch.Generator):
    """Put ``recipe`` and its initial slots on ``state`` (a
    ``train.state.TrainState``); the slot-free recipes leave the slots
    ``None``. Returns the state."""
    state.recipe = recipe
    state.recipe_params, state.recipe_opt_state, state.recipe_state = recipe.init_slots(
        state.model, generator)
    return state


def attach_for_config(cfg, state):
    """``(state, recipe)`` in one call, the driver's entry point. The slots'
    random draws (the predictor's init, then the queue's rows) come from a
    CPU generator seeded ``cfg.seed + 2`` (the probe takes ``seed``, the
    augmentation ``seed + 1``), so they are the same on every device."""
    recipe = build_recipe(cfg)
    generator = torch.Generator().manual_seed(cfg.seed + 2)
    return attach_recipe_slots(recipe, state, generator), recipe
