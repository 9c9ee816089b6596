"""Contrastive loss (SupCon / SimCLR NT-Xent), dense form.

Same semantics as ``simclr_pytorch_distributed_tpu/ops/losses.py``
``supcon_loss``, which follows the reference ``losses.py:17-93``:

- the final ``-(temperature / base_temperature)`` scale, with
  ``base_temperature`` fixed at 0.07 whatever ``temperature`` is;
- the detached per-row max subtraction;
- self-contrast masking of the leading diagonal only;
- ``contrast_mode`` 'one' / 'all'.

It materializes the ``[A, V*B]`` logits and three more temporaries of that
size; the fused kernels (``ops/fused_loss.py``) compute the same value and
gradient without them, and this dense form is their oracle.

The SSL recipes' losses (JAX ``ops/losses.py:119-243``, ``recipes/``):
:func:`byol_loss`, :func:`simsiam_loss` (its stop-gradient inside),
:func:`vicreg_loss` (with its three unweighted terms) and
:func:`moco_queue_loss`, which with an empty queue and ``key == query`` is
the SimCLR loss exactly. Each takes view-major ``[2B, D]`` rows (``[v1 of
every sample; v2 of every sample]``), computes in fp32 and is plain
PyTorch: the JAX package computes them in plain XLA too, outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from simclr_pytorch_distributed_tpu_torch.ops.metrics import embedding_covariance


def supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
    contrast_mode: str = "all",
) -> torch.Tensor:
    """Supervised-contrastive / SimCLR loss over ``[batch, n_views, dim]``
    features, which the caller has L2-normalized. With ``labels``
    ``[batch]`` positives share a label (SupCon); without, the loss is
    SimCLR's NT-Xent (positives are the other views of the same sample)."""
    if features.dim() < 3:
        raise ValueError("`features` must be [batch, n_views, ...]")
    if features.dim() > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    batch_size, n_views = features.shape[0], features.shape[1]
    dtype, device = features.dtype, features.device

    if labels is None:
        mask = torch.eye(batch_size, dtype=dtype, device=device)
    else:
        labels = labels.reshape(-1, 1)
        if labels.shape[0] != batch_size:
            raise ValueError("Num of labels does not match num of features")
        mask = (labels == labels.T).to(dtype)

    # rows [v0 b0..bN, v1 b0..bN, ...] (reference losses.py:53)
    contrast_feature = features.transpose(0, 1).reshape(n_views * batch_size, -1)
    if contrast_mode == "one":
        anchor_feature = features[:, 0]
        anchor_count = 1
    elif contrast_mode == "all":
        anchor_feature = contrast_feature
        anchor_count = n_views
    else:
        raise ValueError(f"Unknown mode: {contrast_mode}")

    anchor_dot_contrast = (anchor_feature @ contrast_feature.T) / temperature
    logits_max = anchor_dot_contrast.max(dim=1, keepdim=True).values.detach()
    logits = anchor_dot_contrast - logits_max

    mask = mask.repeat(anchor_count, n_views)
    # the leading diagonal of the [A, V*B] mask, as a view: an indexed
    # write waits for the card
    logits_mask = torch.ones_like(mask)
    logits_mask.diagonal().zero_()
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1)

    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, batch_size).mean()


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization with a zero-row guard: the recipe losses'
    normalizer. The contrastive path keeps its bare ``feats / norm(feats)``
    (``train/supcon_step.py``), as in the JAX package."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def _cross_views(x: torch.Tensor) -> torch.Tensor:
    """Swap the two view blocks of view-major ``[2B, D]`` rows, so row ``i``
    lands on its positive's row ``(i + B) % 2B``."""
    b = x.shape[0] // 2
    return torch.cat([x[b:], x[:b]], dim=0)


def byol_loss(online_pred: torch.Tensor, target_proj: torch.Tensor) -> torch.Tensor:
    """BYOL's regression loss (Grill et al. 2020, eq. 2), symmetrized: the
    online predictions against the OTHER view's target projection, both
    unnormalized ``[2B, D]``; the caller detaches the target. With unit
    rows the squared error is ``2 - 2 cos``: 0 aligned, 2 orthogonal."""
    p = l2_normalize(online_pred.to(torch.float32))
    t = _cross_views(l2_normalize(target_proj.to(torch.float32)))
    return torch.square(p - t).sum(dim=1).mean()


def simsiam_loss(pred: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """SimSiam's negative cosine (Chen & He 2021, eq. 1), symmetrized:
    ``pred = h(f(x))`` and ``proj = f(x)`` of the same branch, unnormalized
    ``[2B, D]``. The stop-gradient on the projection side, the paper's
    whole mechanism, is applied here, so no caller can forget it. In
    ``[-1, 0]``, -1 at perfect alignment."""
    p = l2_normalize(pred.to(torch.float32))
    z = _cross_views(l2_normalize(proj.to(torch.float32))).detach()
    return -(p * z).sum(dim=1).mean()


def vicreg_loss(
    z1: torch.Tensor,
    z2: torch.Tensor,
    *,
    sim_coeff: float = 25.0,
    std_coeff: float = 25.0,
    cov_coeff: float = 1.0,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """VICReg (Bardes et al. 2022) over the two views' unnormalized ``[B, D]``
    projections: ``(loss, parts)``, ``parts`` the three unweighted terms
    ``vicreg_inv``, ``vicreg_var``, ``vicreg_cov`` (the recipe's metric
    columns). The covariance is ``ops/metrics.embedding_covariance``,
    centered and unbiased, as the health diagnostics build theirs."""
    z1 = z1.to(torch.float32)
    z2 = z2.to(torch.float32)
    d = z1.shape[1]
    inv = torch.square(z1 - z2).mean()
    var_terms, cov_terms = [], []
    for z in (z1, z2):
        std = torch.sqrt(z.var(dim=0, unbiased=False) + eps)
        var_terms.append(torch.relu(1.0 - std).mean())
        cov = embedding_covariance(z, center=True, ddof=1)
        off_diag = cov - torch.diag(torch.diag(cov))
        cov_terms.append(torch.square(off_diag).sum() / d)
    var = 0.5 * (var_terms[0] + var_terms[1])
    cov = 0.5 * (cov_terms[0] + cov_terms[1])
    loss = sim_coeff * inv + std_coeff * var + cov_coeff * cov
    return loss, {"vicreg_inv": inv, "vicreg_var": var, "vicreg_cov": cov}


def moco_queue_loss(
    query: torch.Tensor,
    key: torch.Tensor,
    queue: torch.Tensor,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
) -> torch.Tensor:
    """MoCo-style NT-Xent: the online L2-normalized ``query`` rows ``[2B, D]``
    against the momentum encoder's ``key`` rows (detached by the caller)
    and the ``[K, D]`` ``queue`` of past keys, negatives only. Row ``i``'s
    positive is the key of its other view, ``key[(i + B) % 2B]``; its own
    view's key (column ``i``) is masked like the SimCLR self-pair. The op
    order is :func:`supcon_loss`'s (the detached row max, the mask, the
    ``-(T / base_T)`` scale), so with ``K = 0`` and ``key == query`` it is
    the SimCLR loss exactly."""
    n = query.shape[0]
    b = n // 2
    contrast = torch.cat([key, queue.to(query.dtype)], dim=0)
    logits = (query @ contrast.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    # views, not index tensors: an indexed write or read waits for the card
    logits_mask = torch.ones_like(logits)
    logits_mask.diagonal().zero_()
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    # row i's positive, column (i + B) % 2B: two diagonals of the key block
    keys = log_prob[:, :n]
    positive = torch.cat([keys.diagonal(b), keys.diagonal(-b)])
    loss = -(temperature / base_temperature) * positive
    return loss.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, the probe's loss
    (JAX ``ops/losses.py:246``; reference ``main_linear.py:121, 173``)."""
    return F.cross_entropy(logits, labels.long())
