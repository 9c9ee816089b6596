"""Prometheus text exposition and the trainer's liveness gauges, stdlib
only.

The port's own copy of the JAX package's ``utils/prom.py``. The trainers'
optional metrics sidecar (``--metrics_port``) serves the
:class:`TrainerGauges`: the step counter, the last flush boundary's age,
the telemetry windows in flight, the health window means and the terminal
exit code, the signal an external watchdog needs to tell "training" from
"wedged" without touching the device. The serving stack (``serve/``)
exposes its engine and batcher counters and the per-bucket
:class:`LatencyHistogram` on ``GET /metrics``, and reads the same
histogram's quantiles into ``/stats``, so the two views cannot drift.

Exposition format: the Prometheus text format (``name{label="v"} value``
lines). Histograms follow the native convention (cumulative ``_bucket``
series with an ``le`` label, plus ``_sum``/``_count``).
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

Sample = Tuple[str, Optional[dict], float]


def _fmt_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_value(value) -> str:
    """Exact rendering: '%g' would quantize to 6 significant digits, which
    corrupts large counters (a step counter past ~1e6, a latency _sum) —
    Prometheus rate()/increase() over quantized counters can even go
    negative. Integers render as integers; floats via repr (shortest
    round-trip)."""
    v = float(value)
    if v.is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(v)


def render_prometheus(samples: Iterable[Sample]) -> str:
    """Prometheus text lines from ``(name, labels_or_None, value)`` samples."""
    lines = []
    for name, labels, value in samples:
        if labels:
            inner = ",".join(
                f'{k}="{_fmt_label(v)}"' for k, v in sorted(labels.items())
            )
            lines.append(f"{name}{{{inner}}} {_fmt_value(value)}")
        else:
            lines.append(f"{name} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


# default request-latency bounds (ms): log-spaced from sub-batch-window to
# the server's 30 s result timeout; an overflow bucket catches the rest
DEFAULT_BOUNDS_MS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
)


class LatencyHistogram:
    """Per-key fixed-bound latency histograms with interpolated quantiles.

    ``observe(key, ms)`` is O(buckets) under one lock — cheap enough for
    the serve completion path. Quantiles interpolate linearly inside the
    bucket that crosses the rank (overflow observations clamp to the top
    bound), which is the standard histogram-quantile tradeoff: bounded
    memory, no reservoir bias, accuracy set by the bound spacing. Values
    come from the CALLER'S clock (the batcher's injectable ``clock``), so
    the whole latency story is fake-clock-testable.
    """

    def __init__(self, bounds_ms: Sequence[float] = DEFAULT_BOUNDS_MS):
        bounds = tuple(float(b) for b in bounds_ms)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"bounds must be strictly increasing, got {bounds}")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts: Dict[str, list] = {}  # key -> [len(bounds)+1 counts]
        self._sums: Dict[str, float] = {}

    def observe(self, key, ms: float) -> None:
        key = str(key)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
                self._sums[key] = 0.0
            i = 0
            while i < len(self.bounds) and ms > self.bounds[i]:
                i += 1
            counts[i] += 1
            self._sums[key] += float(ms)

    def _quantile_locked(self, counts, q: float) -> float:
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                if i >= len(self.bounds):  # overflow: clamp to the top bound
                    return self.bounds[-1]
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.bounds[-1]

    def quantile(self, key, q: float) -> float:
        with self._lock:
            counts = self._counts.get(str(key))
            if counts is None:
                return 0.0
            return self._quantile_locked(counts, q)

    def summary(self) -> dict:
        """``{key: {count, mean_ms, p50_ms, p95_ms, p99_ms}}`` — the
        ``/stats`` latency section."""
        out = {}
        with self._lock:
            for key, counts in self._counts.items():
                n = sum(counts)
                out[key] = {
                    "count": n,
                    "mean_ms": (self._sums[key] / n) if n else 0.0,
                    "p50_ms": self._quantile_locked(counts, 0.50),
                    "p95_ms": self._quantile_locked(counts, 0.95),
                    "p99_ms": self._quantile_locked(counts, 0.99),
                }
        return out

    def samples(self, name: str, key_label: str = "bucket") -> list:
        """Prometheus-native cumulative ``_bucket``/``_sum``/``_count``
        series, one set per key."""
        out = []
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cum = 0
                for bound, c in zip(self.bounds, counts):
                    cum += c
                    out.append((
                        f"{name}_bucket",
                        {key_label: key, "le": f"{bound:g}"}, cum,
                    ))
                cum += counts[-1]
                out.append((f"{name}_bucket", {key_label: key, "le": "+Inf"}, cum))
                out.append((f"{name}_sum", {key_label: key}, self._sums[key]))
                out.append((f"{name}_count", {key_label: key}, cum))
        return out


class TrainerGauges:
    """The trainer sidecar's liveness surface, updated at flush boundaries.

    ``beat(step)`` stamps the boundary clock (wired through
    ``TelemetrySession.flush_boundary``, the point the stall watchdog
    watches); ``set()`` records other gauges (the epoch, the windows in
    flight, and on health-enabled pretrain runs the ``health_*``/``probe_*``
    window means the ``HealthMonitor`` stamps from the flush job);
    ``register()`` attaches callables evaluated at scrape time.
    ``last_boundary_age_seconds`` is the liveness signal: it climbs
    exactly while the run is wedged.

    ``start_time_seconds`` is the wall clock at construction (uptime
    without ``/proc``), and the terminal ``exit_code`` gauge is stamped by
    :meth:`set_exit_code` on the way out of the driver
    (``utils/obs.RunObservability.close``), so the last scrape classifies
    the exit (75 preempted, 3 health > 2 flush > 1 NaN; ``utils/guard.py``).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {"start_time_seconds": wall_clock()}
        self._lazy: Dict[str, Callable[[], float]] = {}
        self._last_boundary: Optional[float] = None

    def set_exit_code(self, code: int) -> None:
        """Stamp the terminal exit-code gauge (once, on the exit path)."""
        self.set(exit_code=int(code))

    def beat(self, step: int) -> None:
        with self._lock:
            self._values["step"] = float(step)
            self._last_boundary = self._clock()

    def set(self, **kv) -> None:
        with self._lock:
            for k, v in kv.items():
                self._values[k] = float(v)

    def register(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._lazy[name] = fn

    def collect(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._values)
            lazy = dict(self._lazy)
            last = self._last_boundary
            out["last_boundary_age_seconds"] = (
                self._clock() - last if last is not None else -1.0
            )
        for name, fn in lazy.items():
            try:
                out[name] = float(fn())
            except Exception:  # noqa: BLE001 — a scrape must never raise
                out[name] = -1.0
        return out

    def prometheus_text(self, prefix: str = "train_") -> str:
        return render_prometheus(
            (prefix + name, None, value)
            for name, value in sorted(self.collect().items())
        )


def start_metrics_server(
    port: int, text_fn: Callable[[], str], host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """A daemon-threaded ``GET /metrics`` (+ ``/healthz``) HTTP server —
    the trainer sidecar. ``port=0`` binds an ephemeral port
    (``server.server_address`` reports it); callers ``shutdown()`` it in
    their ``finally``. Loopback by default: exposing an unauthenticated
    endpoint beyond the host is an explicit ``host=`` choice
    (``--metrics_host``)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            if self.path == "/metrics":
                body = text_fn().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
            elif self.path == "/healthz":
                body = b'{"status": "ok"}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
            else:
                body = b"not found"
                self.send_response(404)
                self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet: scrapes every few secs
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    t = threading.Thread(
        target=server.serve_forever, name="metrics-sidecar", daemon=True
    )
    t.start()
    return server
