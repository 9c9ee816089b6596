"""Step timing and a windowed ``torch.profiler`` trace.

:class:`StepTracer` is the JAX package's ``utils/profiling.StepTracer``
(``--trace_dir``, ``--trace_start_step``, ``--trace_steps``) on
``torch.profiler``: at the first step at or past ``start_step`` it opens
a window holding the next ``num_steps`` steps, then stops and writes a
Chrome trace, ``<trace_dir>/trace_steps_<a>_<b>.json`` for steps ``a`` to
``b - 1`` (CPU ops and the drivers' ``record_function`` ranges, and on
CUDA the device kernels and copies, with each range's device span). On
CUDA the window's edges wait for the device, so the trace holds exactly
its steps' device work. Outside the window it does nothing. One window a
run.

:class:`StepClock` times the steps of an epoch without waiting for the
device: a CUDA event is recorded on the compute stream at each step
boundary and the events are read after the epoch; on the CPU it reads the
host's clock.

:func:`count_collectives` runs a function with the ``torch.distributed``
collectives of the tensor-parallel step counted by group (``model``,
``data`` or ``world``, ``parallel/mesh.py``): calls, payload bytes and
host seconds, the device synchronized around each call so that the
seconds are the collective's. It is an instrument for measurement
scripts; the trainers do not call it.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import torch


class StepTracer:
    def __init__(self, trace_dir: str, start_step: int = 10, num_steps: int = 10,
                 enabled: bool = True):
        self.trace_dir = trace_dir
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.enabled = bool(trace_dir) and enabled and self.num_steps > 0
        self.profile: Optional[torch.profiler.profile] = None
        self.path: Optional[str] = None
        self._first = self._taken = 0

    def _start(self, global_step: int) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()  # the window holds no earlier step's work
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.start()
        self._first, self._taken = global_step + 1, 0
        logging.info("profiler: tracing steps [%d, %d) -> %s", self._first,
                     self._first + self.num_steps, self.trace_dir)

    def step(self, global_step: int) -> None:
        """Call once per step, after it is dispatched, with its global step.
        ``>=``: after a resume the first step seen may be past
        ``start_step``, and the window still opens."""
        if not self.enabled:
            return
        if self.profile is None:
            if global_step >= self.start_step:
                self._start(global_step)
            return
        self.profile.step()
        self._taken += 1
        if self._taken >= self.num_steps:
            self.close()

    def close(self) -> None:
        """Stop an open window and write its trace (also on a failure
        exit, when the trace is most useful)."""
        if self.profile is None or not self.enabled:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's steps have run
        self.profile.stop()
        self.enabled = False  # one window a run
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(
            self.trace_dir,
            f"trace_steps_{self._first}_{self._first + self._taken}.json")
        self.profile.export_chrome_trace(self.path)
        logging.info("profiler: wrote %s", self.path)


class StepClock:
    """Step times of one epoch on the device's clock (the host's on the
    CPU). :meth:`mark` at the start of the epoch's first step and after
    each step is dispatched; :meth:`seconds` gives the spans between
    consecutive marks, reading the CUDA events once at the end."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: List = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        marks, self._marks = self._marks, []
        if len(marks) < 2:
            return []
        if self.cuda:
            marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        return [b - a for a, b in zip(marks, marks[1:])]

    def fill(self, entries: Dict[int, dict], first_step: int) -> None:
        """Set ``step_time`` in the history ``entries`` (global step ->
        entry) of the steps timed since the last read, the first of which
        was ``first_step``."""
        for k, seconds in enumerate(self.seconds()):
            if first_step + k in entries:
                entries[first_step + k]["step_time"] = seconds


COUNTED_COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "broadcast")


def count_collectives(fn) -> Dict[str, list]:
    """``fn()`` with each collective of :data:`COUNTED_COLLECTIVES` counted
    by group: ``{"name@group": [calls, bytes, seconds]}``. Bytes are the
    payload: an all-gather's gathered output, a reduce-scatter's input, an
    all-reduce's or a broadcast's tensor. On CUDA the device is
    synchronized before and after each call."""
    import torch.distributed as dist
    from simclr_pytorch_distributed_tpu_torch.parallel import mesh
    spent: Dict[str, list] = {}
    originals = {name: getattr(dist, name) for name in COUNTED_COLLECTIVES}

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def wrap(name, call):
        def run(*args, **kwargs):
            group = kwargs.get("group")
            tag = ("model" if group is not None and group is mesh.model_group() else
                   "data" if group is not None and group is mesh.data_group() else "world")
            tensors = (args[0] if name == "all_gather" else
                       args[1] if name == "reduce_scatter" else [args[0]])
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            sync()
            t0 = time.perf_counter()
            out = call(*args, **kwargs)
            sync()
            entry = spent.setdefault(f"{name}@{tag}", [0, 0, 0.0])
            entry[0] += 1
            entry[1] += nbytes
            entry[2] += time.perf_counter() - t0
            return out
        return run

    for name, call in originals.items():
        setattr(dist, name, wrap(name, call))
    try:
        fn()
    finally:
        for name, call in originals.items():
            setattr(dist, name, call)
    return spent
