"""BatchNorm for the eager path in either compute dtype, and the train-mode
running statistics of the fused conv path.

The fused kernels (``ops/fused_conv.py``) compute the batch moments and the
normalization themselves and return the moments; the ``nn.BatchNorm2d``
modules stay the owners of the affine parameters and the running buffers,
so a state dict is the same whichever path or compute dtype trained it.
This module applies the running update to those buffers, with the torch
convention of the JAX package's ``models/norm.py``
(``running_stats_update``, lines 42-59), and runs the eager BN over bf16
activations with fp32 statistics (``batch_norm``, the JAX
``CrossReplicaBatchNorm``'s ``xf = x.astype(f32)`` ... ``y.astype(x.dtype)``,
lines 157 and 227).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` applied to ``x`` of any compute dtype: batch statistics in
    fp32, fp32 parameters and running buffers, the output in ``x.dtype``.

    PyTorch's batch norm takes a bf16 input beside fp32 parameters and
    buffers and computes in fp32 (on the CPU and in cuDNN alike), so this
    is the module's own call; it raises on a bf16 input if the module was
    cast away from fp32, which would keep the buffers in bf16."""
    fp32 = (torch.float32, torch.float32)
    if x.dtype == torch.bfloat16 and (bn.weight.dtype, bn.running_var.dtype) != fp32:
        raise ValueError(f"batch_norm: a bf16 input needs fp32 BN parameters and buffers, "
                         f"got {bn.weight.dtype} and {bn.running_var.dtype}")
    return bn(x)


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
