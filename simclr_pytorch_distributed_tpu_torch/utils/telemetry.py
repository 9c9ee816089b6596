"""The background flush behind the metric ring (JAX ``utils/telemetry.py``).

The main thread never reads a step's metrics back. Each step writes them
into the device-side ring (``ops/metrics.MetricRing``); at each
``print_freq`` boundary the main thread snapshots the ring (a clone and an
event, no wait) and keeps dispatching, and the one device-to-host copy,
``check_finite_loss``, the meters, the TensorBoard scalars, the health
monitor and the progress line run on one background telemetry thread,
strictly FIFO.

Semantics (held by ``tests/test_torch_port_telemetry.py``):

- the values are the very same device computations, only fetched later, so
  ``--telemetry async`` and ``sync`` log the same floats;
- preemption stays on the main thread at the drivers' deterministic step
  boundaries;
- NaN detection is at most one window late, and collective: the worker's
  ``NonFiniteLossError`` re-raises on the main thread at the next boundary
  through :meth:`TelemetrySession.check_failures_global`, or at the
  epoch-end drain. Under ``--nan_policy rollback`` the epoch is discarded
  from its epoch-top backup either way. A failure other than a non-finite
  loss (a TensorBoard ``IOError``, a bug in a consume job) exits as
  :class:`TelemetryFlushError` instead, never through the NaN policy;
- epoch ends and emergency saves drain first, so the meters and the
  history are complete when they are read.

``mode='sync'`` runs every job inline on the calling thread (the control
arm, ``--telemetry sync``). Failure handling is the same in both modes: a
job's exception is stored and raised at the boundary.

Under a process group the failure codes of the processes meet in one
all-gather at every boundary (gloo on the CPU, NCCL on the card; the JAX
package's multihost allgather, JAX ``utils/telemetry.py:418-473``), so every
process leaves the loop at the same boundary through the same exception
type; without a group there is no collective. Each process's row carries
its wait inside the previous boundary's gather beside its code, so every
process also learns the fleet's arrival skew and which process the others
waited on: the ``boundary_skew_seconds``, ``boundary_straggler`` and
``process_count`` gauges the supervisor's straggler tracker reads
(``supervise/observe.py``), and the ``boundary_skew`` event on the fleet
track.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Mapping, Optional, Sequence, Tuple

from simclr_pytorch_distributed_tpu_torch.ops.metrics import MetricRing
from simclr_pytorch_distributed_tpu_torch.utils import tracing

_STOP = object()


class TelemetryFlushError(RuntimeError):
    """A background window-flush job failed for a reason other than a
    non-finite loss (a TensorBoard ``IOError``, a transfer fault, a bug in
    a consume callback). Distinct from ``NonFiniteLossError``, so the NaN
    policy never rolls back epochs over an I/O error: this aborts under
    both ``--nan_policy`` modes, with exit code 2. The original exception
    rides as ``__cause__`` on the process that saw it."""


class FlushExecutor:
    """One background worker draining window jobs FIFO; exceptions re-raise
    on the main thread at the next boundary."""

    def __init__(self, mode: str = "async"):
        if mode not in ("async", "sync"):
            raise ValueError(f"telemetry mode must be async|sync, got {mode!r}")
        self.mode = mode
        self._exc: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._unfinished = 0
        self._closed = False
        if mode == "async":
            self._q: "queue.SimpleQueue" = queue.SimpleQueue()
            self._thread = threading.Thread(
                target=self._run, name="telemetry-flush", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                return
            try:
                # once poisoned, queued jobs are discarded (their metrics
                # post-date the failure) until the main thread observes the
                # exception through poll(), which clears the poison only
                # after the queue is drained
                if self._exc is None:
                    job()
            except BaseException as e:  # noqa: BLE001 - forwarded, not handled
                self._exc = e
            finally:
                with self._cv:
                    self._unfinished -= 1
                    self._cv.notify_all()

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a window job; in ``sync`` mode it runs inline. Submission
        never raises a job's exception: whether a flush has completed by a
        given boundary depends on scheduling, so failures surface only
        through ``poll``/``drain``/``TelemetrySession.check_failures_global``
        at the drivers' deterministic points."""
        if self._closed:
            raise RuntimeError("FlushExecutor is closed")
        if self.mode == "sync":
            if self._exc is None:
                try:
                    job()
                except BaseException as e:  # noqa: BLE001 - forwarded
                    self._exc = e
            return
        with self._cv:
            self._unfinished += 1
        self._q.put(job)

    def wait_idle(self) -> None:
        if self.mode == "sync":
            return
        with self._cv:
            while self._unfinished:
                self._cv.wait()

    def unfinished(self) -> int:
        """Window jobs submitted and not yet completed (the sidecar's
        in-flight-windows gauge)."""
        with self._cv:
            return self._unfinished

    def poll(self) -> None:
        """Re-raise the first worker exception on the calling thread, after
        draining the queue; the executor is then clean and reusable (the
        rollback policy keeps training on the same run)."""
        if self._exc is None:
            return
        self.wait_idle()
        exc, self._exc = self._exc, None
        raise exc

    def drain(self) -> None:
        """Block until every submitted job completed, then surface errors."""
        self.wait_idle()
        self.poll()

    def close(self) -> None:
        """Stop the worker. Never raises a pending exception (it runs in
        ``finally`` blocks, where a raise would mask the real failure)."""
        if self._closed:
            return
        self._closed = True
        if self.mode == "sync":
            return
        self._q.put(_STOP)
        self._thread.join()


class TelemetrySession:
    """The ring and executor pair the epoch drivers share.

    The driver's flow::

        ring_buf = session.init_buffer(device)          # fresh each epoch
        session.ring.write(ring_buf, metrics, step)     # each step, on device
        session.append(info, step)                      # host bookkeeping
        ...at each print_freq boundary...
        session.flush_boundary(ring_buf, consume, ...)  # snapshot + queue

    ``blocks`` are the ring's tensor-valued columns (``MetricRing``).
    """

    def __init__(
        self,
        window: int,
        keys: Sequence[str],
        mode: str = "async",
        device_get: Optional[Callable] = None,
        watchdog=None,
        gauges=None,
        blocks: Optional[Mapping[str, Tuple[int, ...]]] = None,
    ):
        self.ring = MetricRing(window, keys, device_get=device_get, blocks=blocks)
        self.executor = FlushExecutor(mode)
        self.mode = mode
        self._window_start = time.time()
        # host-only hooks, beaten and stamped at the deterministic flush
        # boundaries: "the boundary stopped advancing" is the signal of a
        # wedged collective or device rather than ordinary slowness
        self._watchdog = watchdog
        self._gauges = gauges
        # this process's wait (ms) inside the previous boundary's gather,
        # sent with the next one; -1 until a gather has been timed
        self._last_wait_ms = -1

    def init_buffer(self, device=None):
        return self.ring.init_buffer(device)

    def pending_count(self) -> int:
        return self.ring.pending_count()

    def append(self, info, step: int) -> None:
        self.ring.append(info, step)

    def submit_window(self, ring_buf, consume: Callable) -> None:
        """Snapshot the pending window and hand ``consume(fetched_rows)`` to
        the executor. An empty window is a no-op, never a raise point."""
        pending = self.ring.take_window()
        if not pending:
            return
        snapshot = self.ring.snapshot(ring_buf)

        def job():
            # the transfer and consume side of the window, on its own track
            # on whichever thread runs it (main:* tracks never nest)
            with tracing.span("flush_job", track="telemetry:flush", steps=len(pending)):
                consume(self.ring.resolve(snapshot, pending))

        self.executor.submit(job)

    def drain(self) -> None:
        self.executor.drain()

    def drain_global(self, step_hint: int = 0) -> None:
        """Collective drain for the epoch-loop exits: wait for every
        submitted job (no raise: completion timing is per process), then
        observe failures collectively, ahead of a save every process
        enters."""
        self.executor.wait_idle()
        self.check_failures_global(step_hint)
        if self._watchdog is not None:
            self._watchdog.beat()

    def start_window_clock(self) -> None:
        """Reset the boundary-to-boundary wall clock (at an epoch's start);
        an epoch edge is progress for the watchdog too."""
        self._window_start = time.time()
        if self._watchdog is not None:
            self._watchdog.beat()

    def flush_boundary(self, ring_buf, consume: Callable, batch_meter=None,
                       step_hint: int = 0) -> None:
        """The drivers' shared ``print_freq``-boundary protocol, in order:

        1. meter the closing window on the main thread as boundary-to-
           boundary wall time over its steps (``batch_meter``, when given),
           so windows partition the loop's wall clock;
        2. snapshot and queue the flush (one transfer per window);
        3. observe failures collectively (:meth:`check_failures_global`).

        With ``batch_meter``, ``consume`` is called as ``consume(fetched,
        (val, avg))`` with the meter as it was here: the async job runs
        while later boundaries keep updating it.
        """
        with tracing.span("flush_boundary", track="main:flush", step=step_hint,
                          steps=self.pending_count()):
            if batch_meter is not None:
                n_pending = self.pending_count()
                if n_pending:
                    now = time.time()
                    batch_meter.update((now - self._window_start) / n_pending, n=n_pending)
                    self._window_start = now
                bt = (batch_meter.val, batch_meter.avg)
                self.submit_window(ring_buf, lambda fetched: consume(fetched, bt))
            else:
                self.submit_window(ring_buf, consume)
        self.check_failures_global(step_hint)
        if self._watchdog is not None:
            self._watchdog.beat()
        if self._gauges is not None:
            self._gauges.beat(step_hint)
            self._gauges.set(inflight_windows=self.executor.unfinished())

    def finish_epoch(self, submit_tail: Callable[[int], None], step_hint: int) -> None:
        """The epoch-end epilogue: ``submit_tail(step_hint)`` (the driver's
        own boundary helper, a no-op unless steps are pending), then a
        collective drain, so the meters are complete and the raise point is
        matched across processes ahead of the epoch-end save."""
        submit_tail(step_hint)
        self.drain_global(step_hint)

    def close(self) -> None:
        self.executor.close()

    def _failure_code(self) -> int:
        """0 clean, 1 non-finite loss, 2 any other flush failure, 3 a
        representation-health abort (``guard.HealthMonitor`` under
        ``--health_policy abort``)."""
        exc = self.executor._exc
        if exc is None:
            return 0
        from simclr_pytorch_distributed_tpu_torch.utils.guard import (
            NonFiniteLossError,
            RepresentationHealthError,
        )

        if isinstance(exc, RepresentationHealthError):
            return 3
        return 1 if isinstance(exc, NonFiniteLossError) else 2

    def check_failures_global(self, step_hint: int = 0) -> None:
        """Collective failure observation at a boundary.

        Under async telemetry, whether a process's flush has completed by a
        boundary depends on scheduling, so a lone process raising out of
        the loop while its peers dispatch the next window's collectives
        would deadlock them. Every process calls this at every boundary;
        the rows ``[code, previous wait in ms]`` of the processes meet in
        one all-gather, and if any process has a failure, every process
        drains and raises here through the type the largest code names: a
        health abort (3) outranks a flush failure (2), which outranks a
        non-finite loss (1). A process whose own windows were clean raises
        the type the code names too. Without a process group of more than
        one process there is no collective.

        The waits are one boundary stale by construction: for a
        synchronous collective each process's wait is about the last
        arrival's time less its own, so their spread is the fleet's arrival
        skew and the process that waited least arrived last, the straggler
        (JAX ``utils/telemetry.py:418-473``). The exchange widens the one
        collective the boundary already had; it adds none.
        """
        from simclr_pytorch_distributed_tpu_torch.parallel import mesh

        code = self._failure_code()
        world = mesh.world_size()
        if world > 1:
            import torch
            import torch.distributed as dist

            device = mesh.collective_device()
            t_arrive = time.monotonic()
            with tracing.span("failure_code_allgather", track="main:collective",
                              step=step_hint, local_code=code):
                row = torch.tensor([code, self._last_wait_ms], dtype=torch.int32, device=device)
                gathered = torch.empty(world * 2, dtype=torch.int32, device=device)
                dist.all_gather_into_tensor(gathered, row)
                rows = gathered.view(world, 2).tolist()
            wait_s = time.monotonic() - t_arrive
            self._last_wait_ms = min(int(round(wait_s * 1e3)), 2**31 - 1)
            code = max(r[0] for r in rows)
            waits = [r[1] for r in rows]
            if self._gauges is not None:
                self._gauges.set(collective_wait_seconds=wait_s)
            if min(waits) >= 0:
                skew_s = (max(waits) - min(waits)) / 1e3
                straggler = waits.index(min(waits))
                if self._gauges is not None:
                    # who is slow and out of how many: the supervisor's
                    # rebalance and exclusion rungs need both
                    self._gauges.set(boundary_skew_seconds=skew_s,
                                     boundary_straggler=float(straggler),
                                     process_count=float(world))
                tracing.event("boundary_skew", track=tracing.FLEET_TRACK, step=step_hint,
                              skew_s=round(skew_s, 6), straggler=straggler)
        elif self._gauges is not None:
            # one process: nobody to wait on; the keys read 0, not absent,
            # and straggler -1 names nobody (the tracker's benign case)
            self._gauges.set(collective_wait_seconds=0.0, boundary_skew_seconds=0.0,
                             boundary_straggler=-1.0, process_count=1.0)
        # the matched instant every process just left: the fleet timelines'
        # alignment ruler
        tracing.clock_anchor("flush_boundary", step=step_hint)
        if code == 0:
            return
        tracing.event("flush_failure", track="main:guard", code=code, step=step_hint)
        from simclr_pytorch_distributed_tpu_torch.utils.guard import (
            NonFiniteLossError,
            RepresentationHealthError,
        )

        try:
            self.drain()  # re-raises this process's own exception, if any
        except BaseException as e:
            # the exit type is a function of the reduced code alone: a
            # failure that landed after the exchange must not make this
            # process's policy diverge from its peers'
            if code == 3:
                if isinstance(e, RepresentationHealthError):
                    raise
                raise RepresentationHealthError(
                    ["peer reported a representation health alarm"], step_hint
                ) from e
            if code == 2:
                raise TelemetryFlushError(
                    f"telemetry flush failed near global step {step_hint}"
                ) from e
            if isinstance(e, NonFiniteLossError):
                raise
            raise NonFiniteLossError(float("nan"), step_hint) from e
        if code == 3:
            raise RepresentationHealthError(
                ["peer reported a representation health alarm"], step_hint
            )
        if code == 2:
            raise TelemetryFlushError(
                f"peer telemetry flush failed near global step {step_hint}"
            )
        raise NonFiniteLossError(float("nan"), step_hint)
