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

Cross-replica BN (``--syncBN``, JAX ``models/norm.py:211``): with a process
group set and more than one process, :func:`batch_norm` normalizes over the
global batch through :class:`SyncBatchNorm`, an autograd function whose
forward all-reduces the per-channel ``[sum x, sum x^2, count]`` in fp32 and
whose backward all-reduces ``[sum dy, sum dy * x_hat]``; the running update
takes the global statistics and the global count. It runs the same code on
CPU and CUDA tensors (``torch.nn.SyncBatchNorm`` takes CUDA tensors only).
Without a group, each process's ``nn.BatchNorm2d`` normalizes over its own
slice of the batch: the reference's per-GPU BN, which the JAX package
reproduces as ``local_groups=P, group_views=2`` (``norm.py:158-205``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

_CHANNEL = (1, -1, 1, 1)


class SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN of NCHW ``x`` over the batch of every process in
    ``group``, statistics in fp32, the output in ``x.dtype``. The forward
    returns ``(y, mean, biased var, global count)``; only ``y`` carries a
    gradient. ``dgamma``/``dbeta`` are this process's sums: the train
    step's gradient mean adds them up across processes with every other
    parameter's gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        c = x.shape[1]
        local = torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device),
        ])
        dist.all_reduce(local, group=group)
        count = local[2 * c]
        mean = local[:c] / count
        var = local[c:2 * c] / count - mean * mean
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        y = (xf - mean.view(_CHANNEL)) * invstd.view(_CHANNEL) * weight.view(_CHANNEL)
        y = y + bias.view(_CHANNEL)
        ctx.mark_non_differentiable(mean, var, count)
        return y.to(x.dtype), mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dyf = dy.float()
        x_hat = (x.float() - mean.view(_CHANNEL)) * invstd.view(_CHANNEL)
        sum_dy = dyf.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dyf * x_hat).sum(dim=(0, 2, 3))
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        c = x.shape[1]
        dx = (dyf - (sums[:c] / count).view(_CHANNEL)
              - x_hat * (sums[c:] / count).view(_CHANNEL))
        dx = dx * (weight * invstd).view(_CHANNEL)
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None


def sync_active(group) -> bool:
    """Whether BN over ``group`` is cross-replica: a group is set and it
    holds more than one process."""
    return group is not None and dist.is_initialized() and dist.get_world_size(group) > 1


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, group=None) -> torch.Tensor:
    """``bn`` applied to ``x`` of any compute dtype: batch statistics in
    fp32, fp32 parameters and running buffers, the output in ``x.dtype``.

    PyTorch's batch norm takes a bf16 input beside fp32 parameters and
    buffers and computes in fp32 (on the CPU and in cuDNN alike), so this
    is the module's own call; it raises on a bf16 input if the module was
    cast away from fp32, which would keep the buffers in bf16. In train
    mode with a ``group`` of more than one process (``--syncBN``) the
    statistics are those of the global batch (:class:`SyncBatchNorm`), and
    the running buffers take them with the global count."""
    fp32 = (torch.float32, torch.float32)
    if x.dtype == torch.bfloat16 and (bn.weight.dtype, bn.running_var.dtype) != fp32:
        raise ValueError(f"batch_norm: a bf16 input needs fp32 BN parameters and buffers, "
                         f"got {bn.weight.dtype} and {bn.running_var.dtype}")
    if not (bn.training and sync_active(group)):
        return bn(x)
    y, mean, var, count = SyncBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, group)
    apply_running_update(bn, mean, var, count)
    return y


def running_stats_update(
    ra_mean: torch.Tensor, ra_var: torch.Tensor,
    batch_mean: torch.Tensor, batch_var_biased: torch.Tensor,
    count, momentum: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``new = (1 - m) * old + m * batch``, with the BIASED batch variance
    rescaled to the UNBIASED one for the running buffer. ``count`` is the
    values per channel behind the batch moments (an int, or a 0-dim tensor
    for the global count of cross-replica BN)."""
    if isinstance(count, torch.Tensor):
        unbiased = batch_var_biased * (count / (count - 1).clamp_min(1))
    else:
        unbiased = batch_var_biased * (count / max(count - 1, 1))
    return (
        (1.0 - momentum) * ra_mean + momentum * batch_mean,
        (1.0 - momentum) * ra_var + momentum * unbiased,
    )


@torch.no_grad()
def apply_running_update(
    bn: nn.BatchNorm2d, batch_mean: torch.Tensor, batch_var_biased: torch.Tensor,
    count,
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
