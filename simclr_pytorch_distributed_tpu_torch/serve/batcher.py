"""DynamicBatcher — async request queue + pipelined micro-batching.

The port's copy of the JAX package's ``serve/batcher.py`` (standard
library threads and numpy; the spans and the ``StallWatchdog`` are the
port's ``utils/tracing.py``). With ``EmbeddingEngine.dispatch`` as its
``dispatch_fn``, the assembler thread enqueues a batch's work on the card
and the completer thread waits on that batch's own CUDA event
(``serve/engine.py``).

Serving traffic arrives as many small concurrent requests, but the engine's
throughput comes from large batches (the per-dispatch overhead and the
padded-bucket waste both amortize with batch size). The batcher bridges the
two: ``submit(images)`` returns a ``concurrent.futures.Future`` immediately,
and an assembler thread coalesces queued requests into one engine call
under two knobs:

- ``max_batch`` — dispatch as soon as the coalesced batch would exceed it;
- ``max_wait_ms`` — never hold the FIRST request of a batch longer than this
  (the latency the batcher is allowed to add hunting for batch-mates).

**Pipelined execution.** With a ``dispatch_fn`` (the engine's async API,
``EmbeddingEngine.dispatch``) the data path splits into two overlapped
stages: the assembler keeps coalescing and DISPATCHING — host padding, H2D,
enqueueing the forward — while up to ``max_inflight`` earlier batches
are still computing on device, and a completer thread resolves each batch's
futures as its transfer lands. Without the split, batch k's host phases and
batch k+1's device phases serialize (the device idles during every host
phase and vice versa — the serving analogue of the per-iter sync that cost
the training loop 2.4x wall clock in the JAX package). The window is bounded in
BOTH batches (``max_inflight``) and total in-flight rows
(``max_inflight_images``) so pipelining cannot hold unbounded HBM; a batch
larger than the row bound is still admitted alone (the engine chunks it).
Completion is strictly FIFO in dispatch order, so per-request ordering and
the existing QueueFull/timeout/close-drain semantics are unchanged. With
only a synchronous ``embed_fn`` the same code path runs with the compute
folded into the dispatch stage (the pre-pipeline behavior).

Backpressure is explicit: the queue is bounded BOTH in requests
(``max_queue``) and in total queued image rows (``max_queue_images`` —
request count alone would let a burst of large batches hold gigabytes of
pixels), and a full queue REJECTS new submits with :class:`QueueFull`
instead of growing without bound — an overloaded server answers 503 now rather than OOMing
later (serve/server.py maps it). Per-request timeouts (``timeout_ms``)
expire stale work at dequeue time with :class:`RequestTimeout` so a deep
queue cannot burn engine cycles on answers nobody is waiting for.

Time is read through an injectable ``clock`` (default ``time.monotonic``);
deadline logic never touches the wall clock directly, so tests drive
``max_wait_ms``/timeout expiry with a fake clock instead of sleeping
(the batcher tests). ``close()`` drains in-flight work by default.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from simclr_pytorch_distributed_tpu_torch.utils import tracing


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the submit was rejected, not queued."""


class RequestTimeout(TimeoutError):
    """The request's ``timeout_ms`` expired before the worker reached it."""


@dataclass
class _Request:
    images: np.ndarray
    n: int
    future: Future = field(default_factory=Future)
    deadline: Optional[float] = None  # clock() value; None = no timeout
    # lifecycle stamps (batcher ``clock`` domain): submit -> dispatch ->
    # completion; the per-bucket latency histogram and the flight
    # recorder's per-request spans both read them
    t_submit: float = 0.0
    t_dispatch: float = 0.0


class _EagerHandle:
    """Adapter giving a synchronous ``embed_fn`` the handle shape of
    ``EmbeddingEngine.dispatch``: the compute already happened at dispatch,
    ``result()`` just hands it back. Keeps one code path through the
    pipeline for both engine spellings."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


@dataclass
class _Inflight:
    """One dispatched-but-uncompleted batch in the pipeline window."""

    batch: list  # [_Request]
    total: int  # rows (the max_inflight_images accounting unit)
    handle: object  # .result() -> [total, dim]


class DynamicBatcher:
    def __init__(
        self,
        embed_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        *,
        dispatch_fn: Optional[Callable[[np.ndarray], object]] = None,
        max_batch: int = 128,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        max_queue_images: int = 8192,
        max_inflight: int = 2,
        max_inflight_images: int = 4096,
        default_timeout_ms: Optional[float] = None,
        validate: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        clock: Callable[[], float] = time.monotonic,
        poll_interval: float = 0.002,
        start: bool = True,
        latency=None,
        bucket_fn: Optional[Callable[[int], int]] = None,
        watchdog=None,
    ):
        if max_batch < 1 or max_queue < 1 or max_queue_images < 1:
            raise ValueError(
                "max_batch, max_queue, and max_queue_images must be >= 1"
            )
        if max_inflight < 1 or max_inflight_images < 1:
            raise ValueError(
                "max_inflight and max_inflight_images must be >= 1"
            )
        if embed_fn is None and dispatch_fn is None:
            raise ValueError("need embed_fn or dispatch_fn")
        if embed_fn is not None and dispatch_fn is not None:
            # silently preferring one would serve requests through a
            # different function than the caller supplied
            raise ValueError("pass embed_fn OR dispatch_fn, not both")
        if dispatch_fn is None:
            # synchronous engine: compute runs inside the dispatch stage and
            # completion is a no-op — the pre-pipeline behavior, and what
            # the policy unit tests' fake embed functions exercise
            dispatch_fn = lambda images: _EagerHandle(embed_fn(images))  # noqa: E731
        self._dispatch_fn = dispatch_fn
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._max_queue = int(max_queue)
        # request COUNT alone doesn't bound memory — 256 pending requests of
        # large batches is gigabytes of pixels; cap total queued rows too
        self._max_queue_images = int(max_queue_images)
        self._pending_images = 0
        # optional synchronous request gate (e.g. the engine's geometry
        # check): bad requests fail at submit() instead of poisoning a
        # coalesced batch in the worker
        self._validate = validate
        self._default_timeout_ms = default_timeout_ms
        self._clock = clock
        # real-time condition-wait granularity inside the coalescing window;
        # deadlines themselves are computed from ``clock`` so a fake clock
        # controls WHEN the window closes, polling only bounds how fast the
        # worker notices
        self._poll = float(poll_interval)
        self._cond = threading.Condition()
        self._pending: "deque[_Request]" = deque()
        self._closed = False
        # pipeline window: batches dispatched to the device but not yet
        # materialized. Only the assembler appends, only the completer pops
        # — so the completer may peek [0] unlocked-result() safely.
        self._max_inflight = int(max_inflight)
        self._max_inflight_images = int(max_inflight_images)
        self._inflight: "deque[_Inflight]" = deque()
        self._inflight_rows = 0
        self._assembler_done = False
        # time-weighted pipeline occupancy (∫depth·dt), read via ``clock`` so
        # the gauges are as fake-clock-testable as the deadlines
        self._occ_start = self._clock()
        self._occ_last = self._occ_start
        self._occ_area = 0.0  # ∫ inflight_depth dt
        self._occ_busy = 0.0  # time with >= 1 batch in flight
        # liveness anchor: when the pipeline last delivered a completion
        # (success OR failure — both are forward progress; a replica that
        # only ever errors is unhealthy on `errors`, not on liveness).
        # Initialized to construction time so `last_completion_age_s` reads
        # "seconds since the batcher last proved it can finish work" from
        # the very first scrape — the replica-fleet supervisor's stall
        # signal (supervise/replica.py), meaningful only alongside
        # queue_depth/inflight_batches > 0 (an idle server ages too).
        self._last_completion = self._occ_start
        self._stats = {
            "submitted": 0,
            "rejected": 0,
            "timeouts": 0,
            "batches": 0,
            "batched_images": 0,
            "dispatched_batches": 0,
            "errors": 0,
            "max_queue_depth": 0,
            "max_batch_observed": 0,
            "max_inflight_observed": 0,
        }
        # observability (utils/prom.py, utils/tracing.py; all optional):
        # ``latency`` is a LatencyHistogram observed per REQUEST at
        # completion, keyed by ``bucket_fn(n)`` (the engine's bucket,
        # serve/server.py wires ``engine.bucket_for``) — timed with the same
        # injectable ``clock`` as the deadlines, so /stats quantiles and the
        # /metrics exposition are fake-clock-testable. ``watchdog`` is a
        # tracing.StallWatchdog armed only while batches are in flight: the
        # stall it detects is "the device owes us a completion and isn't
        # delivering", never an idle server.
        self._latency = latency
        self._bucket_fn = bucket_fn
        self._watchdog = watchdog
        if watchdog is not None:
            watchdog.disarm()  # idle until the first dispatch
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._worker, name="batcher-assembler", daemon=True
            )
            self._completer = threading.Thread(
                target=self._completer_loop, name="batcher-completer",
                daemon=True,
            )
            self._thread.start()
            self._completer.start()

    # ------------------------------------------------------------- client

    def submit(
        self, images: np.ndarray, timeout_ms: Optional[float] = None
    ) -> Future:
        """Enqueue one request; resolves to float32 ``[n, dim]`` embeddings.

        Raises :class:`QueueFull` when ``max_queue`` requests are already
        waiting (backpressure — retry later) and ``RuntimeError`` after
        ``close()``. The future fails with :class:`RequestTimeout` if the
        worker cannot reach the request within its timeout.
        """
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"expected [n, H, W, C] images, got {images.shape}")
        n = images.shape[0]
        if n < 1:
            raise ValueError("empty request")
        if self._validate is not None:
            images = self._validate(images)
        if timeout_ms is None:
            timeout_ms = self._default_timeout_ms
        now = self._clock()
        req = _Request(
            images=images,
            n=n,
            deadline=(now + timeout_ms / 1e3)
            if timeout_ms is not None else None,
            t_submit=now,
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            if len(self._pending) >= self._max_queue:
                self._stats["rejected"] += 1
                raise QueueFull(
                    f"request queue full ({self._max_queue} pending requests)"
                )
            if self._pending_images + n > self._max_queue_images:
                self._stats["rejected"] += 1
                raise QueueFull(
                    f"request queue full ({self._pending_images} images "
                    f"pending, row cap {self._max_queue_images})"
                )
            self._pending.append(req)
            self._pending_images += n
            self._stats["submitted"] += 1
            self._stats["max_queue_depth"] = max(
                self._stats["max_queue_depth"], len(self._pending)
            )
            self._cond.notify_all()
        return req.future

    def close(self, drain: bool = True) -> None:
        """Stop accepting submits; by default the pipeline finishes
        everything already queued before exiting (``drain=False`` fails
        QUEUED requests immediately — batches already dispatched to the
        device are completed either way: their compute is spent and their
        waiters are blocked on real futures). With no worker thread
        (``start=False``) there is nobody to drain — queued requests are
        failed either way rather than leaving their futures hanging
        forever."""
        if self._watchdog is not None:
            # closing is expected silence: whatever is left in flight is
            # about to be drained or failed, not stalled
            self._watchdog.disarm()
        with self._cond:
            self._closed = True
            if not drain or self._thread is None:
                while self._pending:
                    req = self._pending.popleft()
                    self._pending_images -= req.n
                    self._fail(req, RuntimeError("DynamicBatcher closed"))
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._completer is not None:
            self._completer.join()
            self._completer = None

    def stats(self) -> dict:
        with self._cond:
            s = dict(self._stats)
            s["queue_depth"] = len(self._pending)
            s["queued_images"] = self._pending_images
            s["inflight_batches"] = len(self._inflight)
            s["inflight_rows"] = self._inflight_rows
            self._occ_tick_locked()  # bring the integrals up to now
            elapsed = self._occ_last - self._occ_start
            s["pipeline_occupancy"] = (
                self._occ_busy / elapsed if elapsed > 0 else 0.0
            )
            s["avg_inflight_depth"] = (
                self._occ_area / elapsed if elapsed > 0 else 0.0
            )
            # numeric leaf -> auto-exported as serve_batcher_last_completion_
            # age_s by serve_metrics_fn: the replica-fleet liveness gauge
            s["last_completion_age_s"] = max(
                0.0, self._occ_last - self._last_completion
            )
        s["max_batch"] = self._max_batch
        s["max_wait_ms"] = self._max_wait_s * 1e3
        s["max_queue"] = self._max_queue
        s["max_queue_images"] = self._max_queue_images
        s["max_inflight"] = self._max_inflight
        s["max_inflight_images"] = self._max_inflight_images
        if s["batches"]:
            s["avg_batch_images"] = s["batched_images"] / s["batches"]
        return s

    # ------------------------------------------------------------- worker

    def _fail(self, req: _Request, exc: Exception) -> None:
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass  # cancelled by the caller — nothing to deliver

    def _pop_live_locked(self) -> Optional[_Request]:
        """Next unexpired, uncancelled request; expired ones fail in place."""
        while self._pending:
            req = self._pending.popleft()
            self._pending_images -= req.n
            if req.future.cancelled():
                continue
            if req.deadline is not None and self._clock() > req.deadline:
                self._stats["timeouts"] += 1
                self._fail(req, RequestTimeout(
                    "request expired before the batcher reached it"
                ))
                continue
            return req
        return None

    def _next_batch(self):
        """Block for the next micro-batch; ``None`` means closed-and-drained."""
        with self._cond:
            while True:
                req = self._pop_live_locked()
                if req is not None:
                    break
                if self._closed:
                    return None
                self._cond.wait(0.05)
            batch = [req]
            total = req.n
            window_end = self._clock() + self._max_wait_s
            shape = req.images.shape[1:]
            dtype = req.images.dtype
            while total < self._max_batch:
                if self._pending:
                    nxt = self._pending[0]
                    if nxt.future.cancelled():
                        self._pending.popleft()
                        self._pending_images -= nxt.n
                        continue
                    if nxt.deadline is not None and self._clock() > nxt.deadline:
                        self._pending.popleft()
                        self._pending_images -= nxt.n
                        self._stats["timeouts"] += 1
                        self._fail(nxt, RequestTimeout(
                            "request expired before the batcher reached it"
                        ))
                        continue
                    if nxt.images.shape[1:] != shape or nxt.images.dtype != dtype:
                        # incompatible with this batch's geometry: dispatching
                        # together would fail EVERY waiter on the concatenate;
                        # leave it to lead the next (same-shape) batch
                        break
                    if total + nxt.n > self._max_batch:
                        break  # would overflow; leave it for the next batch
                    self._pending.popleft()
                    self._pending_images -= nxt.n
                    batch.append(nxt)
                    total += nxt.n
                    continue
                if self._closed or self._clock() >= window_end:
                    break
                self._cond.wait(self._poll)
        return batch

    # ---------------------------------------------- dispatch & completion

    def _occ_tick_locked(self) -> None:
        """Advance the occupancy integrals to now at the CURRENT depth.

        Must be called (under the lock) immediately before any change to
        ``len(self._inflight)`` so ∫depth·dt charges each interval to the
        depth that actually held during it.
        """
        now = self._clock()
        dt = now - self._occ_last
        if dt > 0:
            depth = len(self._inflight)
            self._occ_area += depth * dt
            if depth:
                self._occ_busy += dt
            self._occ_last = now

    def _start_dispatch(self, batch) -> Optional[_Inflight]:
        """Dispatch stage: concatenate and hand the batch to the engine.

        With the engine's async API this runs only the host phases (padding,
        H2D, enqueueing the forward); the device is computing when it
        returns. A dispatch-time failure fails every waiter here — there is
        nothing in flight to complete."""
        total = sum(r.n for r in batch)
        images = (
            batch[0].images if len(batch) == 1
            else np.concatenate([r.images for r in batch], axis=0)
        )
        now = self._clock()
        for req in batch:
            req.t_dispatch = now
        try:
            with tracing.span("dispatch", track="serve:dispatch", rows=total):
                handle = self._dispatch_fn(images)
        except Exception as exc:  # noqa: BLE001 — delivered to every waiter
            with self._cond:
                self._stats["errors"] += 1
            for req in batch:
                self._fail(req, exc)
            return None
        with self._cond:
            self._stats["dispatched_batches"] += 1
        return _Inflight(batch=batch, total=total, handle=handle)

    def _finish(self, inflight: _Inflight) -> None:
        """Completion stage: block on the result and resolve the futures."""
        try:
            with tracing.span(
                "complete", track="serve:complete", rows=inflight.total
            ):
                emb = inflight.handle.result()
        except Exception as exc:  # noqa: BLE001 — delivered to every waiter
            with self._cond:
                self._stats["errors"] += 1
                self._last_completion = self._clock()
            for req in inflight.batch:
                self._fail(req, exc)
            return
        with self._cond:
            self._last_completion = self._clock()
            self._stats["batches"] += 1
            self._stats["batched_images"] += inflight.total
            self._stats["max_batch_observed"] = max(
                self._stats["max_batch_observed"], inflight.total
            )
        now = self._clock()
        offset = 0
        for req in inflight.batch:
            rows = emb[offset:offset + req.n]
            offset += req.n
            try:
                req.future.set_result(rows)
            except InvalidStateError:
                pass  # cancelled mid-flight
            # per-request observability at the moment the answer exists:
            # the histogram keys on the bucket the request padded into
            # (the same axis the bench reports), the recorder span covers
            # queue -> dispatch -> completion in the batcher's clock domain
            key = self._bucket_fn(req.n) if self._bucket_fn else req.n
            if self._latency is not None:
                self._latency.observe(key, (now - req.t_submit) * 1e3)
            tracing.record_span(
                "request", "serve:request", req.t_submit, now,
                n=req.n, bucket=int(key),
                queue_ms=round((req.t_dispatch - req.t_submit) * 1e3, 3),
            )

    def _dispatch(self, batch) -> None:
        """Synchronous dispatch+complete — the no-worker (``start=False``)
        path the policy unit tests drive batch by batch."""
        inflight = self._start_dispatch(batch)
        if inflight is not None:
            self._finish(inflight)

    def _worker(self) -> None:
        """Assembler: coalesce -> wait for window room -> dispatch.

        Window admission happens BEFORE the dispatch call: the window
        bounds HBM, and the dispatch stage is what allocates device buffers
        (H2D + the enqueued program's outputs). Room only grows between the
        check and the dispatch — the completer is the sole remover and this
        thread the sole adder — so the post-dispatch append needs no
        re-check. The row bound admits an oversized batch alone
        (``self._inflight`` empty) rather than deadlocking on it.
        """
        while True:
            batch = self._next_batch()
            if batch is None:
                break
            total = sum(r.n for r in batch)
            with self._cond:
                while len(self._inflight) >= self._max_inflight or (
                    self._inflight
                    and self._inflight_rows + total > self._max_inflight_images
                ):
                    self._cond.wait(self._poll)
            inflight = self._start_dispatch(batch)
            if inflight is None:
                continue
            with self._cond:
                self._occ_tick_locked()
                self._inflight.append(inflight)
                self._inflight_rows += inflight.total
                self._stats["max_inflight_observed"] = max(
                    self._stats["max_inflight_observed"], len(self._inflight)
                )
                # arm only on the idle->busy edge: re-arming on every
                # dispatch would keep pushing the deadline out while an
                # earlier batch sits stuck — completion, not dispatch, is
                # the progress the watchdog certifies
                if self._watchdog is not None and len(self._inflight) == 1:
                    self._watchdog.arm()
                self._cond.notify_all()
        with self._cond:
            self._assembler_done = True
            self._cond.notify_all()

    def _completer_loop(self) -> None:
        """Completer: resolve in-flight batches strictly FIFO in dispatch
        order (per-request ordering is preserved end to end)."""
        while True:
            with self._cond:
                while not self._inflight and not self._assembler_done:
                    self._cond.wait(self._poll)
                if not self._inflight:
                    return  # assembler exited and the window is drained
                inflight = self._inflight[0]  # peek: stays visible in gauges
            # blocking D2H happens OUTSIDE the lock — submits, stats polls,
            # and the assembler's window wait all proceed meanwhile
            self._finish(inflight)
            with self._cond:
                self._occ_tick_locked()
                self._inflight.popleft()
                self._inflight_rows -= inflight.total
                if self._watchdog is not None:
                    # a completed batch is progress; an emptied window is
                    # expected silence, not a stall
                    if self._inflight:
                        self._watchdog.beat()
                    else:
                        self._watchdog.disarm()
                self._cond.notify_all()
