"""Top-k accuracy and the host-side meter.

``topk_accuracy`` is the reference ``accuracy()`` (``util.py:37-51``):
percent of targets found in the top-k predictions, one value per k.
``topk_correct`` gives the counts instead, which sum over batches (JAX
``ops/metrics.py:51``). ``torch.topk`` and ``jax.lax.top_k`` may order
equal logits differently, so the two packages agree where no two of a
row's top logits tie. A k above the number of classes counts every class
(top-5 of a 3-class probe is 100%), where the JAX function raises.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _hits(logits: torch.Tensor, labels: torch.Tensor, maxk: int) -> torch.Tensor:
    """``[batch, maxk]``: whether the j-th ranked prediction is the label."""
    pred = torch.topk(logits, min(maxk, logits.shape[1]), dim=1).indices
    return pred == labels.reshape(-1, 1).to(pred.dtype)


def topk_accuracy(
    output: torch.Tensor, target: torch.Tensor, topk: Sequence[int] = (1,)
) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent, one 0-dim tensor per k (JAX
    ``ops/metrics.py:18``)."""
    hit = _hits(output, target, max(topk))
    batch_size = target.shape[0]
    return tuple(hit[:, :k].sum().to(torch.float32) * (100.0 / batch_size) for k in topk)


def topk_correct(
    logits: torch.Tensor, labels: torch.Tensor, ks: Sequence[int] = (1, 5)
) -> Dict[int, torch.Tensor]:
    """Top-k correct counts per k (int64 0-dim tensors), summable across
    batches."""
    hit = _hits(logits, labels, max(ks))
    return {k: hit[:, :k].any(dim=1).sum() for k in ks}


class AverageMeter:
    """Running value/average meter (reference ``util.py:19-34``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
