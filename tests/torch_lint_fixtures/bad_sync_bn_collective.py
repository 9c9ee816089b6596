"""KNOWN-BAD: cross-replica BN on the writer only.

``SyncBatchNorm.apply`` all-reduces the batch statistics over its group:
under a process-dependent branch the other ranks never enter it. Another
autograd Function's ``apply`` is no collective and stays silent.
"""

from simclr_pytorch_distributed_tpu_torch.models.norm import SyncBatchNorm


def normalize(x, weight, bias, group, is_main_process, Scale):
    y = Scale.apply(x)
    if is_main_process():
        y = SyncBatchNorm.apply(y, weight, bias, 1e-5, group)[0]
    return y
