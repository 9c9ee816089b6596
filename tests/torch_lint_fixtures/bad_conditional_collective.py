"""KNOWN-BAD: a collective under a process-dependent conditional.

Only rank 0 enters the all-reduce of the gradients; every other rank goes
on to the next step, and the group hangs inside the collective until its
timeout.
"""

import torch.distributed as dist


def mean_on_main(grads, rank):
    if rank() == 0:
        dist.all_reduce(grads)
    return grads
