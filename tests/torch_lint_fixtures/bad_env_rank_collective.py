"""KNOWN-BAD: a collective behind the launcher's RANK environment variable.

``RANK`` names a process, so a barrier that only rank 0 reaches hangs the
others; ``WORLD_SIZE`` is the same everywhere, and the short-circuit on it
below is fine.
"""

import os

import torch.distributed as dist


def barrier_on_main():
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return
    if os.environ["RANK"] == "0":
        dist.barrier()
