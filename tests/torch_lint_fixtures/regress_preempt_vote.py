"""REGRESSION: the preemption vote read back every step.

The port's trainers once took the preemption vote after every step: an
all-reduce of a flag and its ``.item()``, one wait for the card a step,
where the JAX package votes at flush boundaries only.
"""

import torch.distributed as dist


def train_one_epoch(batches, train_step, telemetry, ring_buf, consume, print_freq,
                    local_flag):
    for idx, batch in enumerate(batches):
        train_step(batch)
        flag = local_flag()
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item():
            return idx + 1
        if (idx + 1) % print_freq == 0:
            telemetry.flush_boundary(ring_buf, consume, step_hint=idx)
    return None
