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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from simclr_pytorch_distributed_tpu_torch.ops.fused_loss import (
    fused_sharded_supcon_loss,
    fused_supcon_loss,
)
from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
from simclr_pytorch_distributed_tpu_torch.parallel import collectives
from simclr_pytorch_distributed_tpu_torch.parallel.mesh import is_distributed, world_size
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState

# the loss's fixed final-scale denominator, whatever the temperature
# (reference losses.py:90)
BASE_TEMPERATURE = 0.07

METRIC_KEYS = (
    "learning_rate", "loss", "loss_l2reg", "loss_sec",
    "norm_mean", "norm_var", "record_norm_mean",
)


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


def two_view_forward(model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """``[B, 2, H, W, C]`` images -> ``[2B, D]`` projections, view-major."""
    b = images.shape[0]
    flat = images.transpose(0, 1).reshape((2 * b,) + tuple(images.shape[2:]))
    return model(flat)


def contrastive_loss_terms(
    cfg: SupConStepConfig, n_fea: torch.Tensor, labels: Optional[torch.Tensor]
) -> torch.Tensor:
    """The contrastive term over the normalized view-major ``[2B, D]`` rows
    (the global rows under a process group, this process's own rows for the
    ring); ``labels`` ``[B]`` (global) for SupCon, ``None`` for SimCLR."""
    if cfg.loss_impl == "ring":
        b = n_fea.shape[0] // 2
        return collectives.ring_supcon_loss(
            torch.stack([n_fea[:b], n_fea[b:]], dim=1), labels,
            temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE,
        )
    if cfg.loss_impl == "fused" and is_distributed():
        mine = collectives.own_rows(n_fea)
        b = mine.shape[0] // 2
        return fused_sharded_supcon_loss(
            torch.stack([mine[:b], mine[b:]], dim=1), labels,
            temperature=cfg.temperature, base_temperature=BASE_TEMPERATURE,
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
    its ``labels``).

    Returns the step's metrics (:data:`METRIC_KEYS`) as 0-dim tensors on the
    device, those of the global batch; nothing here waits for the device
    but the collectives.
    """
    if cfg.method not in ("SupCon", "SimCLR"):
        raise ValueError(f"contrastive method not supported: {cfg.method}")
    state.model.train()
    distributed = is_distributed()
    ring = cfg.loss_impl == "ring"
    feats = two_view_forward(state.model, images).to(torch.float32)
    if distributed:
        if not ring:
            feats = collectives.gather_features(feats)
        if cfg.method == "SupCon":
            labels = collectives.gather_global_labels(labels)

    norms = torch.linalg.norm(feats, dim=1)
    if ring:  # the global means from per-process sums (module docstring)
        rows = norms.shape[0] * world_size()
        sums = collectives.global_sum(torch.stack([norms.sum(), torch.square(norms).sum()]))
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
            torch.square(norms - norm_mean_sg).sum(), torch.square(norms - record).sum()]))
        norm_var, loss_sec = sums[0] / rows, sums[1] / rows
    else:
        norm_var = torch.square(norms - norm_mean).mean()
        loss_sec = torch.square(norms - record).mean()
        loss_l2reg = torch.square(norms).mean()

    n_fea = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
    contrastive = contrastive_loss_terms(
        cfg, n_fea, labels if cfg.method == "SupCon" else None
    )
    ramp = state.step / (cfg.epochs * cfg.steps_per_epoch)
    loss = contrastive
    if cfg.sec:
        loss = loss + cfg.sec_wei * ramp * loss_sec
    if cfg.l2reg:
        loss = loss + cfg.l2reg_wei * ramp * loss_l2reg

    lr = state.set_learning_rate()
    state.optimizer.zero_grad(set_to_none=True)
    if distributed:
        (loss * world_size() / cfg.grad_div).backward()
        collectives.mean_gradients(state.model.parameters())
    else:
        (loss / cfg.grad_div).backward()
    state.optimizer.step()
    if distributed:  # BN buffers follow rank 0 (equal already under --syncBN)
        collectives.broadcast_from_rank0(state.model, parameters=False)
    state.step += 1
    state.record_norm_mean = record
    return {
        "learning_rate": torch.tensor(lr),
        "loss": loss.detach(),
        "loss_l2reg": loss_l2reg.detach(),
        "loss_sec": loss_sec.detach(),
        "norm_mean": norm_mean_sg,
        "norm_var": norm_var.detach(),
        "record_norm_mean": record,
    }
