"""KNOWN-BAD: a readback read before the copy is waited for.

``host.copy_(..., non_blocking=True)`` returns before the device has
written ``host``; reading it at once reads rows that may not have landed.
The second function waits on the event first and is fine.
"""

import torch


def metrics_now(host, snapshot):
    host.copy_(snapshot, non_blocking=True)
    return host.numpy()


def metrics_after_wait(host, snapshot):
    host.copy_(snapshot, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()
