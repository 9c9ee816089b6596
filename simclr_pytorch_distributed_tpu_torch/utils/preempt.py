"""Preemption: SIGTERM/SIGINT -> a flag -> a clean exit between steps.

The port's own copy of the JAX package's ``utils/preempt.py``. The handler
only sets a flag; the drivers check it at each ``--print_freq`` flush
boundary (JAX ``train/supcon.py:633-635``, ``train/linear.py:452-454``,
``train/ce.py:346-348``), where the host waits for the device anyway, and
at an epoch's end; never between boundaries, where under a process group
the vote would be an all-reduce and a readback every step. So a signal
stops the run at the same step as the JAX driver's. The pretrain driver then
saves the full training state with its position in the epoch
(``preempt_epoch_{e}_step_{k}.pth``) and exits with :data:`EXIT_PREEMPTED`,
so a launcher can tell "re-run me with --resume" from a failure. The resume
is bitwise equal to the run that did not stop: the epoch's batch order is a
function of (seed, epoch, start_step) and the checkpoint carries the
augmentation generator's state.

Under data parallelism a signal may reach one process only, or reach them
at different steps. :func:`requested_global` is every process's agreement
on the flags, an all-reduce (MAX) over the process group: every process
calls it at the same flush boundary (JAX ``utils/preempt.py:91``), so all of
them stop at the same step and exit 75, where one process alone would
leave its peers waiting in the next step's collectives.
"""

from __future__ import annotations

import logging
import signal
from typing import Optional

import torch
import torch.distributed as dist

from simclr_pytorch_distributed_tpu_torch.parallel.mesh import collective_device, world_size

# EX_TEMPFAIL from sysexits.h: "temporary failure, retry later": state was
# saved cleanly, re-run the same command with --resume <run folder>.
EXIT_PREEMPTED = 75

_SIGNALS = (signal.SIGTERM, signal.SIGINT)

_received: Optional[int] = None
_prev_handlers: dict = {}


def _handler(signum, frame):  # noqa: ARG001 - signal handler signature
    global _received
    if _received is not None and signum == signal.SIGINT:
        # a second Ctrl-C while the first drains: abort now
        raise KeyboardInterrupt
    _received = signum


def install() -> None:
    """Install the flag-setting handlers (idempotent). Off the main thread
    it warns and installs nothing, so a signal keeps its default action."""
    global _received
    if _prev_handlers:
        return
    _received = None
    try:
        for s in _SIGNALS:
            _prev_handlers[s] = signal.signal(s, _handler)
    except ValueError:  # not the main thread
        _prev_handlers.clear()
        logging.warning(
            "preemption handlers need the main thread; running without "
            "SIGTERM-triggered checkpointing"
        )


def uninstall() -> None:
    """Restore the previous handlers and clear the flag."""
    global _received
    while _prev_handlers:
        s, prev = _prev_handlers.popitem()
        signal.signal(s, prev)
    _received = None


def requested() -> bool:
    return _received is not None


def requested_global() -> bool:
    """Whether any process of the group saw a signal: an all-reduce (MAX)
    of the local flags, which every process must call at the same step
    boundary. Without a group of more than one process, the local flag."""
    if world_size() == 1:
        return requested()
    flag = torch.tensor([float(requested())], device=collective_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def signal_name() -> str:
    return signal.Signals(_received).name if _received is not None else "none"


def request(signum: int = signal.SIGTERM) -> None:
    """Set the flag as the handler would, without a signal."""
    global _received
    _received = signum
