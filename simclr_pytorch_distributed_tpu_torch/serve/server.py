"""Stdlib HTTP JSON endpoint over the engine + batcher — no new runtime deps.

The port's copy of the JAX package's ``serve/server.py``, with the same
flags and payloads, plus ``--device`` (``cuda``, the default, or ``cpu``;
no silent fallback). ``python -m
simclr_pytorch_distributed_tpu_torch.serve.server --ckpt <run>/last.pth``
serves a checkpoint of the port's trainers.

Endpoints:

- ``POST /embed`` — body ``{"images": [[...]]}`` (nested uint8 lists) or
  ``{"images_b64": "<base64 raw bytes>", "shape": [n, h, w, 3]}``; optional
  ``"timeout_ms"``. Replies ``{"embeddings": [[...]], "dim": D, "n": N}``.
- ``GET /healthz`` — liveness: ``{"status": "ok"}``.
- ``GET /stats``  — engine/batcher/cache counters plus per-bucket request
  latency quantiles (p50/p95/p99 — the observability the bench and
  operators read).
- ``GET /metrics`` — Prometheus text exposition of the same counters and
  latency histograms (utils/prom.py), so external scrapers see liveness
  and saturation without parsing ``/stats`` JSON. The quantiles and the
  histogram series are computed from the SAME clock-injectable
  ``LatencyHistogram`` — the two views cannot drift.

Status mapping makes the backpressure contract visible on the wire:
``QueueFull`` -> **503** (+ ``Retry-After``), a request/future timeout ->
**504**, malformed input -> **400**. ``ThreadingHTTPServer`` gives one
thread per connection, which is exactly what the DynamicBatcher wants:
concurrent handlers all block on their own futures while the worker thread
coalesces their requests into shared engine batches.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import os
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from simclr_pytorch_distributed_tpu_torch.serve.batcher import (
    DynamicBatcher,
    QueueFull,
    RequestTimeout,
)

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 * 1024 * 1024  # one request can't OOM the server


def decode_images(payload: dict) -> np.ndarray:
    """Images from a request body: ``"images"`` (nested uint8 lists) or
    ``"images_b64"`` + ``"shape"`` (base64 raw bytes). Shared with the
    multi-model frontend (serve/fleet/frontend.py) so both servers accept
    byte-identical payloads."""
    if "images_b64" in payload:
        shape = payload.get("shape")
        if not isinstance(shape, (list, tuple)) or len(shape) != 4:
            raise ValueError("images_b64 requires 'shape': [n, h, w, c]")
        try:
            raw = base64.b64decode(payload["images_b64"], validate=True)
        except (binascii.Error, TypeError) as e:
            raise ValueError(f"invalid base64 image payload: {e}")
        shape = tuple(int(s) for s in shape)
        expect = int(np.prod(shape))
        if len(raw) != expect:
            raise ValueError(
                f"payload is {len(raw)} bytes but shape {shape} needs {expect}"
            )
        return np.frombuffer(raw, np.uint8).reshape(shape)
    if "images" in payload:
        arr = np.asarray(payload["images"])
        if arr.dtype.kind not in "iuf":
            raise ValueError(f"non-numeric image payload ({arr.dtype})")
        if arr.ndim != 4:
            raise ValueError(f"expected [n, h, w, c] images, got shape {arr.shape}")
        if arr.min() < 0 or arr.max() > 255:
            raise ValueError("pixel values must be uint8 (0..255)")
        return arr.astype(np.uint8)
    raise ValueError("body must carry 'images' or 'images_b64'+'shape'")


def make_handler(
    batcher: DynamicBatcher, stats_fn, *, result_timeout_s: float = 30.0,
    metrics_fn=None,
):
    """Build the request-handler class bound to one batcher.

    ``stats_fn`` is any ``() -> dict`` (the engine's ``stats``, wrapped to
    merge batcher/cache views); keeping it a callable means the handler —
    and its tests — need no engine at all. ``metrics_fn`` is an optional
    ``() -> str`` Prometheus text renderer behind ``GET /metrics`` (absent
    = 404, the pre-observability surface).
    """

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, obj: dict, extra_headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, stats_fn())
            elif self.path == "/metrics" and metrics_fn is not None:
                body = metrics_fn().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/embed":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length <= 0 or length > MAX_BODY_BYTES:
                # replying WITHOUT reading the body would leave its bytes in
                # the keep-alive stream to be parsed as the next request —
                # advertise and perform a connection close so the protocol
                # can't desync (send_header('Connection','close') also sets
                # self.close_connection)
                self._reply(400, {"error": f"bad Content-Length {length}"},
                            [("Connection", "close")])
                return
            try:
                payload = json.loads(self.rfile.read(length))
                images = decode_images(payload)
                timeout_ms = payload.get("timeout_ms")
                if timeout_ms is not None and (
                    not isinstance(timeout_ms, (int, float))
                    or isinstance(timeout_ms, bool) or timeout_ms <= 0
                ):
                    raise ValueError(
                        f"timeout_ms must be a positive number, "
                        f"got {timeout_ms!r}"
                    )
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                future = batcher.submit(images, timeout_ms=timeout_ms)
            except QueueFull as e:
                # the explicit backpressure signal: better a retryable 503
                # now than an unbounded queue later
                self._reply(503, {"error": str(e)}, [("Retry-After", "1")])
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            except RuntimeError as e:
                # batcher closed (shutdown race): the request was VALID —
                # tell the client to retry elsewhere, not that it's malformed
                self._reply(503, {"error": str(e)})
                return
            try:
                emb = future.result(
                    timeout=(timeout_ms / 1e3) if timeout_ms is not None
                    else result_timeout_s
                )
            except (RequestTimeout, FutureTimeout) as e:
                future.cancel()
                self._reply(504, {"error": f"embedding timed out: {e}"})
                return
            except Exception as e:  # noqa: BLE001 — engine failure -> 500
                self._reply(500, {"error": str(e)})
                return
            self._reply(
                200,
                {
                    "embeddings": [row.tolist() for row in emb],
                    "dim": int(emb.shape[1]),
                    "n": int(emb.shape[0]),
                },
            )

        def log_message(self, fmt, *args):  # quiet: route through logging
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


def create_server(
    batcher: DynamicBatcher, stats_fn, host: str = "127.0.0.1", port: int = 8000,
    result_timeout_s: float = 30.0, metrics_fn=None,
) -> ThreadingHTTPServer:
    handler = make_handler(
        batcher, stats_fn, result_timeout_s=result_timeout_s,
        metrics_fn=metrics_fn,
    )
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def start_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def combined_stats_fn(engine, batcher: DynamicBatcher, latency=None):
    """The ``/stats`` payload: engine + batcher counters, and — when the
    stack carries a ``LatencyHistogram`` — per-bucket p50/p95/p99 request
    latency (the same histogram ``/metrics`` exposes, so the JSON and
    Prometheus views agree by construction). The batcher section already
    carries the time-weighted ``pipeline_occupancy``/``avg_inflight_depth``
    gauges."""

    def stats():
        out = {"engine": engine.stats(), "batcher": batcher.stats()}
        if latency is not None:
            out["latency"] = latency.summary()
        return out

    return stats


def serve_metrics_fn(engine, batcher: DynamicBatcher, latency=None):
    """Prometheus exposition for ``GET /metrics``: flat counters/gauges
    from the engine and batcher stats (numeric leaves only — the nested
    trace/bucket dicts become labeled series) plus the native cumulative
    latency histograms."""
    from simclr_pytorch_distributed_tpu_torch.utils import prom

    def metrics() -> str:
        samples = []
        es = engine.stats()
        for key in ("requests", "images", "padded_rows", "cache_hit_rows"):
            if key in es:
                samples.append((f"serve_engine_{key}_total", None, es[key]))
        for bucket, count in sorted(es.get("bucket_dispatches", {}).items()):
            samples.append((
                "serve_engine_bucket_dispatches_total",
                {"bucket": bucket}, count,
            ))
        cache = es.get("cache") or {}
        for key, value in sorted(cache.items()):
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                samples.append((f"serve_cache_{key}", None, value))
        bs = batcher.stats()
        for key, value in sorted(bs.items()):
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                samples.append((f"serve_batcher_{key}", None, value))
        if latency is not None:
            samples.extend(latency.samples("serve_request_latency_ms"))
        return prom.render_prometheus(samples)

    return metrics


def build_parser():
    import argparse

    from simclr_pytorch_distributed_tpu_torch.serve.engine import (
        DEFAULT_BUCKETS,
        SERVE_DTYPES,
    )

    p = argparse.ArgumentParser(
        description="batched embedding-inference HTTP server "
                    "(POST /embed, GET /healthz, GET /stats)"
    )
    p.add_argument("--ckpt", default="",
                   help="a .pth in the reference layout or a run folder (its "
                        "latest complete checkpoint); empty = random-init "
                        "--model (smoke/bench)")
    p.add_argument("--model", default="resnet10",
                   help="architecture for random init when --ckpt is empty")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the encoder runs; cuda raises when no card is found")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)),
                   help="comma-separated batch buckets")
    p.add_argument("--max_batch", type=int, default=128)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument("--max_inflight", type=int, default=2,
                   help="pipeline window: batches dispatched to the device "
                        "but not yet materialized (1 = the unpipelined "
                        "serial path)")
    p.add_argument("--max_inflight_images", type=int, default=4096,
                   help="row bound on the pipeline window (caps in-flight "
                        "device memory; batch count alone would not)")
    p.add_argument("--dtype", default="fp32", choices=list(SERVE_DTYPES),
                   help="serving compute dtype: bf16 computes the encoder "
                        "and head in bf16 (BN stats stay fp32, the output "
                        "is returned fp32)")
    p.add_argument("--img_size", type=int, default=None,
                   help="pinned request H=W (default: the checkpoint "
                        "config's --size, else 32); mismatched requests "
                        "get 400")
    p.add_argument("--normalize", action="store_true",
                   help="L2-normalize embeddings (ops/losses.py contract)")
    p.add_argument("--output", default="features",
                   choices=["features", "projection"])
    p.add_argument("--cache_capacity", type=int, default=4096,
                   help="content-keyed LRU rows; 0 disables the cache")
    p.add_argument("--watchdog_secs", type=float, default=0.0,
                   help="stall watchdog: dump all thread stacks when a "
                        "dispatched batch goes this long without a "
                        "completion (armed only while batches are in "
                        "flight); 0 = off")
    p.add_argument("--events_jsonl", default="",
                   help="flight-recorder output path: per-request spans "
                        "(queue->dispatch->completion), cache events, and "
                        "a Chrome-trace export beside it on shutdown "
                        "(utils/tracing.py); empty = off")
    return p


def build_stack(args):
    """Engine + pipelined batcher + HTTP server from parsed args.

    Split from :func:`main` so tests (and embedders) can build the exact
    stack the CLI serves — including ``--dtype bf16`` and the pipeline
    knobs — without entering ``serve_forever``.
    """
    from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache
    from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine
    from simclr_pytorch_distributed_tpu_torch.utils import prom, tracing

    buckets = tuple(int(b) for b in args.buckets.split(","))
    cache = EmbeddingCache(args.cache_capacity) if args.cache_capacity else None
    kwargs = dict(buckets=buckets, normalize=args.normalize,
                  output=args.output, cache=cache, dtype=args.dtype,
                  device=args.device)
    if args.img_size is not None:
        kwargs["img_size"] = args.img_size
    if args.ckpt:
        engine = EmbeddingEngine.from_checkpoint(args.ckpt, **kwargs)
    else:
        logging.warning("--ckpt not given: serving a RANDOM %s", args.model)
        engine = EmbeddingEngine.random_init(
            model_name=args.model, size=kwargs.get("img_size", 32), **kwargs
        )
    watchdog = None
    if getattr(args, "watchdog_secs", 0) and args.watchdog_secs > 0:
        dump_dir = (
            os.path.dirname(os.path.abspath(args.events_jsonl))
            if getattr(args, "events_jsonl", "") else os.getcwd()
        )
        logging.info("serve stall watchdog: %.0fs deadline, dumps to %s",
                     args.watchdog_secs, dump_dir)
        watchdog = tracing.StallWatchdog(
            args.watchdog_secs, dump_dir,
            recorder=tracing.current(), name="serve",
        )
    latency = prom.LatencyHistogram()
    batcher = DynamicBatcher(
        # async dispatch: the assembler pipelines batches onto the device
        # while the completer materializes earlier ones
        dispatch_fn=engine.dispatch,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        max_inflight=args.max_inflight,
        max_inflight_images=args.max_inflight_images,
        # geometry mismatches fail the submit (-> 400), never a worker batch
        validate=engine.validate_images,
        # per-bucket request latency, keyed by the engine's bucket —
        # feeds BOTH the /stats quantiles and the /metrics histograms
        latency=latency, bucket_fn=engine.bucket_for, watchdog=watchdog,
    )
    server = create_server(
        batcher, combined_stats_fn(engine, batcher, latency),
        host=args.host, port=args.port,
        metrics_fn=serve_metrics_fn(engine, batcher, latency),
    )
    # the watchdog thread outlives build_stack: hang it on the server so
    # main()'s finally (and embedders reusing build_stack) can close it
    server.stall_watchdog = watchdog
    return engine, batcher, server


def main(argv=None):
    from simclr_pytorch_distributed_tpu_torch.utils import tracing

    args = build_parser().parse_args(argv)
    recorder = None
    if args.events_jsonl:
        trace_path = os.path.splitext(args.events_jsonl)[0] + ".trace.json"
        recorder = tracing.FlightRecorder(
            args.events_jsonl, trace_path=trace_path
        )
        tracing.install(recorder)
    engine, batcher, server = build_stack(args)
    logging.info("serving %s embeddings (%s) on http://%s:%d",
                 engine.model_name, engine.dtype, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.close()
        if server.stall_watchdog is not None:
            server.stall_watchdog.close()
        tracing.uninstall()
        if recorder is not None:
            recorder.close()


if __name__ == "__main__":
    main()
