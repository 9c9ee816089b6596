"""Train-mode BatchNorm running statistics for the fused conv path.

The fused kernels (``ops/fused_conv.py``) compute the batch moments and the
normalization themselves and return the moments; the ``nn.BatchNorm2d``
modules stay the owners of the affine parameters and the running buffers,
so a state dict is the same whichever path trained it. This module applies
the running update to those buffers, with the torch convention of the JAX
package's ``models/norm.py`` (``running_stats_update``, lines 42-59).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def running_stats_update(
    ra_mean: torch.Tensor, ra_var: torch.Tensor,
    batch_mean: torch.Tensor, batch_var_biased: torch.Tensor,
    count: int, momentum: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``new = (1 - m) * old + m * batch``, with the BIASED batch variance
    rescaled to the UNBIASED one for the running buffer."""
    unbiased = batch_var_biased * (count / max(count - 1, 1))
    return (
        (1.0 - momentum) * ra_mean + momentum * batch_mean,
        (1.0 - momentum) * ra_var + momentum * unbiased,
    )


@torch.no_grad()
def apply_running_update(
    bn: nn.BatchNorm2d, batch_mean: torch.Tensor, batch_var_biased: torch.Tensor,
    count: int,
) -> None:
    """Update ``bn``'s running buffers in place from a fused kernel's batch
    moments over ``count`` values per channel, and count the batch in
    ``num_batches_tracked`` as ``nn.BatchNorm2d`` does in train mode."""
    mean, var = running_stats_update(
        bn.running_mean, bn.running_var, batch_mean, batch_var_biased, count, bn.momentum
    )
    bn.running_mean.copy_(mean)
    bn.running_var.copy_(var)
    bn.num_batches_tracked.add_(1)
