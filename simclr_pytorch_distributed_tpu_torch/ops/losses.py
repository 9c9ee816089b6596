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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
    n_anchor_rows = batch_size * anchor_count
    diag = torch.arange(n_anchor_rows, device=device)
    logits_mask = torch.ones_like(mask)
    logits_mask[diag, diag] = 0.0
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1)

    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, batch_size).mean()


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization with a zero-row guard."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, the probe's loss
    (JAX ``ops/losses.py:246``; reference ``main_linear.py:121, 173``)."""
    return F.cross_entropy(logits, labels.long())
