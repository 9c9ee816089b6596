"""The SimCLR/SupCon train step, on one device or data parallel.

The step of ``simclr_pytorch_distributed_tpu/train/supcon_step.py``
(reference hot loop ``main_supcon.py:242-351``), eagerly:

- both views forward as ONE batch, flattened view-major (rows
  ``[v1 of all samples; v2 of all samples]``), so they share one BN batch;
- feature-norm statistics of the UNNORMALIZED embeddings, the SEC EMA
  (update-then-use, seeded with the first batch) and the linearly ramped
  SEC / l2reg terms (``main_supcon.py:298-317``);
- L2 normalization after the (logical) gather;
- the contrastive term, dense (``ops/losses.py``), fused
  (``ops/fused_loss.py``, the CUDA kernels on the card) or by ring
  (``parallel/collectives.ring_supcon_loss``); ``contrast_mode`` is 'all'
  on every path, the only mode the ring takes (JAX
  ``train/supcon_step.py:327-331``);
- the loss divided by ``grad_div`` before backward: the reference's DDP
  averages gradients over its ``--ngpu`` ranks, each of which backpropagates
  through its own rows only, so the applied gradient is ``1/ngpu`` of the
  global one; weight decay is not scaled.

Data parallel (a ``torch.distributed`` process group of ``P`` processes, one
included, ``parallel/mesh.py``): each process forwards its own slice of the
global batch, then ``parallel/collectives.gather_features`` assembles the
global view-major rows, and the norm statistics, SEC, l2reg and the loss
run over them. The fused loss runs in its sharded form
(``fused_sharded_supcon_loss``: this process's anchor rows against the
global columns; JAX ``train/supcon_step.py:352-373``). The loss is scaled
by ``P / grad_div`` and the gradients averaged over the processes
(``mean_gradients``): each process's gradient is the share of the global
gradient that flows through its rows, so the applied gradient is the exact
global gradient over ``grad_div`` whatever ``P`` is, and at ``P = 1`` the
step is the one-device step bit for bit. Without ``--syncBN`` each process
normalizes over its own rows, and the BN running buffers follow rank 0.

The ring loss (``loss_impl='ring'``, JAX ``train/supcon_step.py:327-350``)
gathers no features, or the ring would save nothing: the feature-norm
statistics, the SEC EMA and the l2reg term come from sums of this
process's rows reduced over the processes (``collectives.global_sum``),
which per row are the same numbers, since the norms are per row; the
loss, its scaling and the gradient mean are as above.

Representation health (``health_freq > 0``, JAX ``train/supcon_step.py:82-90,
130-186, 595-609``): every ``health_freq``-th step (a host ``if`` on the
step, a host int) :func:`contrastive_health_metrics` reads the loss's own
normalized view-major rows, detached, and the step's gradients; on the
other steps the health columns are NaN sentinel values. Under the ring
loss a health step gathers the rows without a gradient first, so P
processes report what one process reports on the global batch. The
effective rank's spectrum is taken on the host from the ``[D, D]``
covariance that rides the metric ring (:func:`effective_rank`), since
``torch.linalg.eigvalsh`` on a CUDA tensor waits for the device.

Online probe (``online_probe``, JAX ``train/supcon_step.py:189-217,
530-545``): a linear classifier with its own SGD trains on the detached
encoder features of both views from the step's one backbone forward
(``SupConResNet.forward_with_features``), so the encoder's update is the
same with the probe on or off; under a process group its gradient is
averaged like the encoder's, and its loss and top-1 are the global batch's.

Recipes (``TrainState.recipe``, ``recipes/``; JAX ``train/supcon_step.py:
448-600``): ``None`` keeps the inline contrastive term above; otherwise
``recipe.loss(cfg, ctx)`` gives the term from a :class:`RecipeContext` of
the step's own forward products, and the SEC and l2reg ramps still add on
top. The recipe's metric columns join the sorted ring layout
(:func:`metric_keys` ``extra``). A trainable recipe's predictor runs in the
same backward as the encoder and takes its own optimizer step, its learning
rate the schedule's at the step (the NaN rollback's ``lr_scale`` damps the
encoder's optimizer only, as in the JAX driver, ``train/supcon.py:748,
:821-840``); ``post_step`` runs after the optimizer steps. Under a process
group the predictor runs after the feature gather, on the global rows, so
its BN statistics are the global batch's and every process computes its
whole gradient: that gradient is divided by ``P`` before the mean, which
makes the applied predictor gradient the one-process gradient of the global
batch, while the encoder's is the sum of the processes' shares as above.
A recipe that reads the global rows (``Recipe.needs_global_rows``: BYOL,
SimSiam, VICReg, the MoCo queue) gets them gathered under ``--loss_impl
ring`` too: the ring shapes only the contrastive term.

Tensor parallelism (``--model_parallel N``, ``parallel/mesh.setup_grid``):
the world is ``D`` data slices by ``N`` model shards. Everything above that
is data parallel runs over the DATA group (``P`` reads ``D``): the feature
and label gathers, the loss (the sharded fused form and the ring over the
data group; at ``D = 1`` the one-device forms), its ``D / grad_div``
scale, the gradient mean and the BN buffers' broadcast. The ranks of one
model group hold the same rows; inside the forward they trade channel
slices over the MODEL group (``models/resnet.tp_input``), each computing
its own channels of every sharded layer, and each takes the optimizer step
on its own shards. ``global_grad_norm`` sums the squares of the sharded
gradients over the model group, once each. A trainable recipe's predictor
reads the gathered rows whole and trades channels over the model group as
the head does (``models/heads.PredictorHead``); its shard's gradient is
its own, divided by ``D`` and averaged over the data group like the
encoder's; ``post_step`` moves an EMA network shard by shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from simclr_pytorch_distributed_tpu_torch.models import LinearClassifier
from simclr_pytorch_distributed_tpu_torch.ops.fused_loss import (
    fused_sharded_supcon_loss,
    fused_supcon_loss,
)
from simclr_pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss, supcon_loss
from simclr_pytorch_distributed_tpu_torch.ops.metrics import embedding_covariance, topk_correct
from simclr_pytorch_distributed_tpu_torch.parallel import collectives
from simclr_pytorch_distributed_tpu_torch.parallel import mesh
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState

# the loss's fixed final-scale denominator, whatever the temperature
# (reference losses.py:90)
BASE_TEMPERATURE = 0.07

METRIC_KEYS = (
    "learning_rate", "loss", "loss_l2reg", "loss_sec",
    "norm_mean", "norm_var", "record_norm_mean",
)

# representation-health diagnostics (--health_freq > 0)
HEALTH_METRIC_KEYS = (
    "health_align",      # mean positive-pair cosine (collapse -> 1.0)
    "health_con_top1",   # contrastive top-1: the positive is the argmax contrast
    "health_eff_rank",   # exp-entropy of the D x D embedding covariance spectrum
    "health_grad_norm",  # global gradient norm (divergence signal)
    "health_neg_max",    # max negative-pair cosine
    "health_neg_mean",   # mean negative-pair cosine (collapse -> 1.0)
    "health_unif",       # Wang-Isola uniformity, log E exp(-2||z_i-z_j||^2)
)
# the ring column the host turns into health_eff_rank (effective_rank)
HEALTH_COV = "health_cov"
# the health columns the step writes as scalars
DEVICE_HEALTH_KEYS = tuple(k for k in HEALTH_METRIC_KEYS if k != "health_eff_rank")

# online linear probe (--online_probe on): loss and top-1 (percent, both views)
ONLINE_PROBE_METRIC_KEYS = ("probe_loss", "probe_top1")


def metric_keys(health: bool = False, online_probe: bool = False,
                extra: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    """The run's full sorted metric-key tuple, as the host reads it (JAX
    ``train/supcon_step.py:96``); ``extra`` is the recipe's own
    ``metric_keys``."""
    keys = METRIC_KEYS + tuple(extra)
    if health:
        keys = keys + HEALTH_METRIC_KEYS
    if online_probe:
        keys = keys + ONLINE_PROBE_METRIC_KEYS
    return tuple(sorted(keys))


def ring_layout(health: bool, online_probe: bool, feat_dim: int,
                extra: Tuple[str, ...] = ()):
    """``(keys, blocks)`` of the run's metric ring: the step's scalar
    columns (the recipe's ``extra`` among them), and with ``health`` the
    ``[feat_dim, feat_dim]`` covariance block in place of
    ``health_eff_rank``."""
    keys = tuple(k for k in metric_keys(health, online_probe, extra)
                 if k != "health_eff_rank")
    return keys, ({HEALTH_COV: (feat_dim, feat_dim)} if health else {})


def contrastive_health_metrics(emb: torch.Tensor, grad_norm: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
    """The health diagnostics of one batch (JAX ``train/supcon_step.py:130``)
    from the loss's own L2-normalized view-major rows ``emb`` ``[2B, D]``
    (row ``i``'s positive at ``(i + B) % 2B``) and the step's global
    gradient norm: 0-dim tensors for :data:`DEVICE_HEALTH_KEYS`, and
    :data:`HEALTH_COV`, the uncentered ``[D, D]`` covariance whose spectrum
    :func:`effective_rank` takes on the host. Nothing here waits for the
    device. A collapsed representation reads align 1, neg_mean and neg_max
    1, eff_rank 1, unif 0 (its maximum)."""
    n = emb.shape[0]
    b = n // 2
    sim = emb @ emb.T
    idx = torch.arange(n, device=emb.device)
    pos_idx = (idx + b) % n
    eye = idx[:, None] == idx[None, :]
    neg = ~(eye | (pos_idx[:, None] == idx[None, :]))
    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    align = torch.sum(emb[:b] * emb[b:], dim=1).mean()
    neg_count = torch.clamp(neg.to(torch.float32).sum(), min=1.0)
    neg_mean = torch.where(neg, sim, zero).sum() / neg_count
    neg_max = torch.where(neg, sim, torch.full_like(zero, -math.inf)).max()
    top1 = 100.0 * (torch.argmax(torch.where(eye, torch.full_like(zero, -math.inf), sim),
                                 dim=1) == pos_idx).to(torch.float32).mean()
    # ||z_i - z_j||^2 = 2 - 2 cos for unit rows: the exponent is in [-8, 0]
    unif = torch.log(torch.where(eye, zero, torch.exp(4.0 * sim - 4.0)).sum() / (n * (n - 1)))
    return {
        "health_align": align,
        "health_con_top1": top1,
        "health_grad_norm": grad_norm,
        "health_neg_max": neg_max,
        "health_neg_mean": neg_mean,
        "health_unif": unif,
        HEALTH_COV: embedding_covariance(emb),
    }


def effective_rank(cov: np.ndarray) -> float:
    """exp(entropy) of the normalized eigenvalue spectrum of ``cov`` (JAX
    ``train/supcon_step.py:175-178``), in float64 on the host; NaN when
    ``cov`` is not finite (a sentinel row, or a diverged step)."""
    cov = np.asarray(cov, np.float64)
    if not np.isfinite(cov).all():
        return float("nan")
    eig = np.clip(np.linalg.eigvalsh(cov), 0.0, None)
    p = eig / max(eig.sum(), 1e-12)
    safe = np.maximum(p, 1e-12)
    entropy = -np.sum(np.where(p > 0, p * np.log(safe), 0.0))
    return float(np.exp(entropy))


def host_metrics(row: Mapping) -> Dict[str, float]:
    """A resolved ring row as the host reads it: :data:`HEALTH_COV` turned
    into ``health_eff_rank``."""
    out = dict(row)
    cov = out.pop(HEALTH_COV, None)
    if cov is not None:
        out["health_eff_rank"] = effective_rank(cov)
    return out


def global_grad_norm(params, model_group=None) -> torch.Tensor:
    """``optax.global_norm`` of the parameters' gradients; with a
    ``model_group`` the whole model's, each leaf's norm made whole by
    ``parallel/mesh.whole_norms`` (the shards' squares summed over the
    group, the replicated leaves counted once)."""
    params = [p for p in params if p.grad is not None]
    norms = torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
    return torch.linalg.vector_norm(mesh.whole_norms(norms, params, model_group))


@dataclasses.dataclass
class OnlineProbe:
    """The online linear probe (JAX ``train/supcon_step.py:189``): a
    ``LinearClassifier`` and its SGD (momentum 0.9, no weight decay,
    constant learning rate). It rides ``TrainState.probe`` and its own
    checkpoint payload."""

    classifier: LinearClassifier
    optimizer: torch.optim.Optimizer


def build_online_probe(model_name: str, n_cls: int, lr: float, momentum: float = 0.9,
                       seed: int = 0, device=None) -> OnlineProbe:
    """The probe of a run: the post-hoc probe's head and recipe, so the
    live curve estimates what the linear probe measures later. Its init is
    drawn from ``seed`` without touching the global generator's state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        classifier = LinearClassifier(model_name, n_cls)
    classifier = classifier.to(device)
    optimizer = torch.optim.SGD(classifier.parameters(), lr=lr, momentum=momentum,
                                dampening=0.0, weight_decay=0.0, nesterov=False)
    return OnlineProbe(classifier=classifier, optimizer=optimizer)


def probe_update(probe: OnlineProbe, features: torch.Tensor, labels: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """One classifier step on the detached fp32 encoder ``features`` of both
    views (this process's ``[2b, F]`` view-major rows, ``labels`` its
    ``[b]``), the gradient averaged over the processes. Returns the global
    batch's ``probe_loss`` and ``probe_top1`` (percent)."""
    labels2 = torch.cat([labels, labels]).long()
    logits = probe.classifier(features)
    loss = cross_entropy_loss(logits, labels2)
    probe.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh.data_distributed():
        collectives.mean_gradients(probe.classifier.parameters(), mesh.data_group())
    probe.optimizer.step()
    correct = topk_correct(logits.detach(), labels2, ks=(1,))[1].to(torch.float32)
    p = mesh.data_parallel()
    total = torch.stack([loss.detach() / p, correct])
    if mesh.data_distributed():
        total = collectives.rank_ordered_sum(total, mesh.data_group())
    return {"probe_loss": total[0], "probe_top1": 100.0 * total[1] / (labels2.shape[0] * p)}


@dataclasses.dataclass(frozen=True)
class SupConStepConfig:
    """Static step configuration (the reference argparse flags)."""

    method: str = "SimCLR"  # {SimCLR, SupCon}
    temperature: float = 0.5
    sec: bool = False
    sec_wei: float = 0.0
    l2reg: bool = False
    l2reg_wei: float = 0.0
    norm_momentum: float = 1.0
    epochs: int = 1000  # the aux ramps run over epochs * steps_per_epoch
    steps_per_epoch: int = 1
    grad_div: float = 2.0
    loss_impl: str = "dense"  # 'dense', 'fused' or 'ring'; resolved from 'auto' upstream
    # the health diagnostics every health_freq-th step (NaN sentinels
    # else); 0 computes none
    health_freq: int = 0
    # the online probe: the state must then carry TrainState.probe
    online_probe: bool = False


@dataclasses.dataclass(frozen=True)
class RecipeContext:
    """What one step hands a recipe's ``loss`` (JAX
    ``train/supcon_step.py:220``): the step's own forward products, so no
    recipe re-runs the online backbone. ``feats`` is the unnormalized fp32
    projection matrix ``[2B, D]``, view-major (the global batch's rows
    under a process group, this process's under the ring loss), ``n_fea``
    its L2-normalized form; ``images`` this process's two-crop batch, for a
    second forward through an EMA network (which the slots hold); ``labels``
    the loss's labels (the global batch's under a process group for
    SupCon)."""

    images: torch.Tensor
    labels: torch.Tensor
    feats: torch.Tensor
    n_fea: torch.Tensor
    recipe_params: Optional[torch.nn.Module]
    recipe_state: Optional[dict]


def global_rows(rows: torch.Tensor) -> torch.Tensor:
    """This process's view-major rows ``[2b, ...]`` as the global batch's
    ``[2B, ...]``, without gradient (``collectives.view_major`` of an
    all-gather over the data group); the rows themselves without one."""
    if not mesh.data_distributed():
        return rows.detach()
    return collectives.view_major(collectives.all_gather(rows.detach(), mesh.data_group()))


def two_view_forward(model: torch.nn.Module, images: torch.Tensor,
                     with_features: bool = False):
    """``[B, 2, H, W, C]`` images -> ``[2B, D]`` projections, view-major;
    with ``with_features`` the pair ``(projections, encoder features)`` of
    one backbone forward."""
    b = images.shape[0]
    flat = images.transpose(0, 1).reshape((2 * b,) + tuple(images.shape[2:]))
    return model.forward_with_features(flat) if with_features else model(flat)


def contrastive_loss_terms(
    cfg: SupConStepConfig, n_fea: torch.Tensor, labels: Optional[torch.Tensor]
) -> torch.Tensor:
    """The contrastive term over the normalized view-major ``[2B, D]`` rows
    (the global rows under a process group, this process's own rows for the
    ring); ``labels`` ``[B]`` (global) for SupCon, ``None`` for SimCLR."""
    group = mesh.data_group()
    if cfg.loss_impl == "ring":
        b = n_fea.shape[0] // 2
        return collectives.ring_supcon_loss(
            torch.stack([n_fea[:b], n_fea[b:]], dim=1), labels,
            temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE,
            group=group,
        )
    if cfg.loss_impl == "fused" and mesh.data_distributed():
        mine = collectives.own_rows(n_fea, group=group)
        b = mine.shape[0] // 2
        return fused_sharded_supcon_loss(
            torch.stack([mine[:b], mine[b:]], dim=1), labels,
            temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE, group=group,
        )
    b = n_fea.shape[0] // 2
    n_features = torch.stack([n_fea[:b], n_fea[b:]], dim=1)
    if cfg.loss_impl == "fused":
        loss_fn = fused_supcon_loss
    elif cfg.loss_impl == "dense":
        loss_fn = supcon_loss
    else:
        raise ValueError(f"loss_impl must be 'dense', 'fused' or 'ring', got {cfg.loss_impl!r}")
    return loss_fn(
        n_features, labels, temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE
    )


def train_step(
    state: TrainState, cfg: SupConStepConfig, images: torch.Tensor, labels: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """One update of ``state`` on two-crop ``images`` ``[B, 2, H, W, C]``
    (this process's slice of the global batch under a process group, with
    its ``labels``), through ``state.recipe`` when it is set.

    Returns the step's metrics as 0-dim tensors on the device, those of the
    global batch: :data:`METRIC_KEYS`, the recipe's ``metric_keys``, with
    ``health_freq`` the health columns (:data:`DEVICE_HEALTH_KEYS`, and
    :data:`HEALTH_COV` on a health step), with ``online_probe``
    :data:`ONLINE_PROBE_METRIC_KEYS`. Nothing here waits for the device but
    the collectives.
    """
    if cfg.method not in ("SupCon", "SimCLR"):
        raise ValueError(f"contrastive method not supported: {cfg.method}")
    if cfg.online_probe != (state.probe is not None):
        raise ValueError(f"online_probe={cfg.online_probe} but the state "
                         f"{'lacks' if state.probe is None else 'carries'} a probe")
    state.model.train()
    recipe = state.recipe
    distributed = mesh.data_distributed()
    data_group, procs = mesh.data_group(), mesh.data_parallel()
    # the ring keeps each process's rows unless the recipe reads the global ones
    ring = cfg.loss_impl == "ring" and (recipe is None or not recipe.needs_global_rows)
    local_labels = labels
    if cfg.online_probe:
        feats, enc_feats = two_view_forward(state.model, images, with_features=True)
        feats = feats.to(torch.float32)
    else:
        feats = two_view_forward(state.model, images).to(torch.float32)
    if distributed:
        if not ring:
            feats = collectives.gather_features(feats, group=data_group)
        if cfg.method == "SupCon":
            labels = collectives.gather_global_labels(labels, data_group)

    norms = torch.linalg.norm(feats, dim=1)
    if ring:  # the global means from per-process sums (module docstring)
        rows = norms.shape[0] * procs
        sums = collectives.global_sum(torch.stack([norms.sum(), torch.square(norms).sum()]),
                                      data_group)
        norm_mean, loss_l2reg = sums[0] / rows, sums[1] / rows
    else:
        norm_mean = norms.mean()
    norm_mean_sg = norm_mean.detach()
    if state.step == 0 or state.record_norm_mean is None:
        record = norm_mean_sg
    else:
        record = (1.0 - cfg.norm_momentum) * state.record_norm_mean + (
            cfg.norm_momentum * norm_mean_sg
        )
    if ring:
        sums = collectives.global_sum(torch.stack([
            torch.square(norms - norm_mean_sg).sum(), torch.square(norms - record).sum()]),
            data_group)
        norm_var, loss_sec = sums[0] / rows, sums[1] / rows
    else:
        norm_var = torch.square(norms - norm_mean).mean()
        loss_sec = torch.square(norms - record).mean()
        loss_l2reg = torch.square(norms).mean()

    n_fea = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
    recipe_aux = {}
    if recipe is None:  # the inline path: the control arm of the recipes
        contrastive = contrastive_loss_terms(
            cfg, n_fea, labels if cfg.method == "SupCon" else None
        )
    else:
        ctx = RecipeContext(images=images, labels=labels, feats=feats, n_fea=n_fea,
                            recipe_params=state.recipe_params, recipe_state=state.recipe_state)
        contrastive, recipe_aux = recipe.loss(cfg, ctx)
    ramp = state.step / (cfg.epochs * cfg.steps_per_epoch)
    loss = contrastive
    if cfg.sec:
        loss = loss + cfg.sec_wei * ramp * loss_sec
    if cfg.l2reg:
        loss = loss + cfg.l2reg_wei * ramp * loss_l2reg

    lr = state.set_learning_rate()
    state.optimizer.zero_grad(set_to_none=True)
    predictor = state.recipe_params if recipe is not None and recipe.trainable else None
    if predictor is not None:
        state.recipe_opt_state.zero_grad(set_to_none=True)
    if distributed:
        (loss * procs / cfg.grad_div).backward()
        params = list(state.model.parameters())
        if predictor is not None:
            # every process holds the predictor's whole gradient (module
            # docstring): 1/P of it each, so the mean is the one-process one
            pgrads = [p.grad for p in predictor.parameters() if p.grad is not None]
            torch._foreach_div_(pgrads, float(procs))  # sync-ok: a host int
            params += list(predictor.parameters())
        collectives.mean_gradients(params, data_group)
    else:
        (loss / cfg.grad_div).backward()
    state.optimizer.step()
    if predictor is not None:
        # the schedule without the rollback's lr_scale, which damps the
        # encoder's optimizer only (JAX train/supcon.py:748, :821-840)
        for group in state.recipe_opt_state.param_groups:
            group["lr"] = float(state.schedule(state.step))  # sync-ok: the schedule of a host int
        state.recipe_opt_state.step()
    if recipe is not None and state.recipe_state is not None:
        state.recipe_state = recipe.post_step(state.recipe_state, model=state.model,
                                              aux=recipe_aux)
    if distributed:  # BN buffers follow rank 0 (equal already under --syncBN)
        collectives.broadcast_from_rank0(state.model, parameters=False,
                                         group=data_group)
    metrics = {
        "learning_rate": torch.full((), lr, device=loss.device),
        "loss": loss.detach(),
        "loss_l2reg": loss_l2reg.detach(),
        "loss_sec": loss_sec.detach(),
        "norm_mean": norm_mean_sg,
        "norm_var": norm_var.detach(),
        "record_norm_mean": record,
    }
    metrics.update((k, v.detach()) for k, v in recipe_aux.items() if k != "recipe_embeddings")
    if cfg.health_freq > 0:
        if state.step % cfg.health_freq == 0:
            with torch.no_grad():
                emb = n_fea.detach()
                if ring and distributed:
                    emb = collectives.view_major(collectives.all_gather(emb, data_group))
                metrics.update(contrastive_health_metrics(
                    emb, global_grad_norm(state.model.parameters(), mesh.model_group())))
        else:
            sentinel = torch.full((len(DEVICE_HEALTH_KEYS),), float("nan"), device=loss.device)
            metrics.update(zip(DEVICE_HEALTH_KEYS, sentinel.unbind()))
    if cfg.online_probe:
        metrics.update(probe_update(state.probe, enc_feats.detach().to(torch.float32),
                                    local_labels))
    state.step += 1
    state.record_norm_mean = record
    return metrics
