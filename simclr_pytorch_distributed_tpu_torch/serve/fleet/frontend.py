"""Multi-model HTTP frontend: one server, N models, hot-swap, retrieval.

The port of the JAX package's ``serve/fleet/frontend.py``: the same
endpoints, flags and payloads, plus ``--device`` (``cuda``, the default,
or ``cpu``), which every engine a promote loads shares.

The wire contract extends serve/server.py (payloads are byte-compatible —
``decode_images`` is shared) with routing and fleet control:

- ``POST /embed`` — as the single-model server, plus optional ``"model"``
  (default = newest promoted) and ``"tenant"`` (admission-quota key).
  Replies carry ``"model"`` so clients see where they routed. Served rows
  feed the model's retrieval index.
- ``POST /models/promote`` — ``{"model": name, "ckpt": path}``: load the
  checkpoint, install it as the model's next version, let the old version
  drain on its own engine (zero failed/dropped requests — the registry
  proves it). Replies the new version and which version is draining.
- ``POST /neighbors`` — ``{"images": ..., "k": 5, "model": ...}``: embed
  the query images through the SAME batcher/admission path as /embed, then
  return top-k ``{"id", "score"}`` neighbors from the model's index
  (brute or IVF per the ``--retrieval_impl`` ladder; ``k`` above
  ``--neighbors_max_k`` is 400 — the index answers ``min(k, entries)``,
  so an unbounded ``k`` would dump the whole index).
- ``GET /models`` — the routing table (names, versions, drain states).
- ``GET /healthz``, ``/stats``, ``/metrics`` — as the single-model server;
  /metrics aggregates the per-model batchers into the UNLABELED gauges the
  replica-fleet supervisor scrapes (supervise/observe.py parses only plain
  ``name value`` lines) and adds per-model labeled series beside them.

Status mapping is identical to serve/server.py: QueueFull (including a
tenant over admission quota) -> 503 + Retry-After, timeouts -> 504,
malformed/unknown-model -> 400, closed -> 503.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from simclr_pytorch_distributed_tpu_torch.serve.batcher import QueueFull, RequestTimeout
from simclr_pytorch_distributed_tpu_torch.serve.fleet import ivf
from simclr_pytorch_distributed_tpu_torch.serve.fleet.registry import (
    AdmissionController,
    ModelRegistry,
)
from simclr_pytorch_distributed_tpu_torch.serve.server import (
    MAX_BODY_BYTES,
    decode_images,
    start_in_thread,
)

logger = logging.getLogger(__name__)


DEFAULT_NEIGHBORS_MAX_K = 100


def make_fleet_handler(
    registry: ModelRegistry,
    *,
    result_timeout_s: float = 30.0,
    promote_loader=None,
    metrics_fn=None,
    neighbors_max_k: int = DEFAULT_NEIGHBORS_MAX_K,
):
    """Request-handler class over one registry.

    ``promote_loader`` is ``(name, ckpt) -> engine`` — injectable so tests
    promote fake engines without checkpoints on disk; absent, /models/promote
    answers 503 (a frontend that cannot load has no business swapping).

    ``neighbors_max_k`` bounds the client-chosen ``k`` on /neighbors
    (0 disables the bound): the index answers ``min(k, entries)``, so an
    unbounded ``k`` lets any client dump the ENTIRE index contents — and
    pay an index-sized response — with one request.
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
                self._reply(200, registry.stats())
            elif self.path == "/models":
                self._reply(200, registry.models_payload())
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

        def _read_payload(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length <= 0 or length > MAX_BODY_BYTES:
                # close so unread body bytes cannot desync keep-alive
                self._reply(400, {"error": f"bad Content-Length {length}"},
                            [("Connection", "close")])
                return None
            return json.loads(self.rfile.read(length))

        def _submit_and_wait(self, payload):
            """The shared /embed and /neighbors ingress: decode, route,
            admit, wait. Returns ``(name, images, embeddings)`` or replies
            the mapped error itself and returns None."""
            images = decode_images(payload)
            timeout_ms = payload.get("timeout_ms")
            if timeout_ms is not None and (
                not isinstance(timeout_ms, (int, float))
                or isinstance(timeout_ms, bool) or timeout_ms <= 0
            ):
                raise ValueError(
                    f"timeout_ms must be a positive number, got {timeout_ms!r}"
                )
            model = payload.get("model")
            tenant = payload.get("tenant", "")
            if model is not None and not isinstance(model, str):
                raise ValueError(f"model must be a string, got {model!r}")
            if not isinstance(tenant, str):
                raise ValueError(f"tenant must be a string, got {tenant!r}")
            try:
                name, future = registry.submit(
                    images, model=model, tenant=tenant, timeout_ms=timeout_ms
                )
            except QueueFull as e:
                self._reply(503, {"error": str(e)}, [("Retry-After", "1")])
                return None
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e).strip("'\"")})
                return None
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
                return None
            try:
                emb = future.result(
                    timeout=(timeout_ms / 1e3) if timeout_ms is not None
                    else result_timeout_s
                )
            except (RequestTimeout, FutureTimeout) as e:
                future.cancel()
                self._reply(504, {"error": f"embedding timed out: {e}"})
                return None
            except Exception as e:  # noqa: BLE001 — engine failure -> 500
                self._reply(500, {"error": str(e)})
                return None
            return name, images, emb

        def do_POST(self):  # noqa: N802
            try:
                if self.path in ("/embed", "/neighbors"):
                    payload = self._read_payload()
                    if payload is None:
                        return
                    served = self._submit_and_wait(payload)
                    if served is None:
                        return
                    name, images, emb = served
                    if self.path == "/embed":
                        registry.index_add(name, images, emb)
                        self._reply(200, {
                            "embeddings": [row.tolist() for row in emb],
                            "dim": int(emb.shape[1]),
                            "n": int(emb.shape[0]),
                            "model": name,
                        })
                        return
                    k = payload.get("k", 5)
                    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                        raise ValueError(f"k must be a positive int, got {k!r}")
                    if neighbors_max_k and k > neighbors_max_k:
                        raise ValueError(
                            f"k={k} exceeds the --neighbors_max_k bound "
                            f"({neighbors_max_k})"
                        )
                    hits = registry.neighbors_lookup(name, emb, k)
                    self._reply(200, {
                        "model": name,
                        "k": k,
                        "neighbors": [
                            [{"id": key, "score": score} for key, score in row]
                            for row in hits
                        ],
                    })
                    return
                if self.path == "/models/promote":
                    payload = self._read_payload()
                    if payload is None:
                        return
                    name = payload.get("model")
                    ckpt = payload.get("ckpt")
                    if not isinstance(name, str) or not name:
                        raise ValueError(f"model must be a name, got {name!r}")
                    if not isinstance(ckpt, str) or not ckpt:
                        raise ValueError(f"ckpt must be a path, got {ckpt!r}")
                    if promote_loader is None:
                        self._reply(503, {
                            "error": "this frontend has no checkpoint loader"
                        })
                        return
                    old_serving = registry.models_payload()["models"].get(
                        name, {}
                    ).get("serving")
                    engine = promote_loader(name, ckpt)
                    mv = registry.promote(name, engine, source=ckpt)
                    self._reply(200, {
                        "model": name,
                        "version": mv.version,
                        "draining": old_serving,
                    })
                    return
                self._reply(404, {"error": f"unknown path {self.path}"})
            except QueueFull as e:
                self._reply(503, {"error": str(e)}, [("Retry-After", "1")])
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e).strip("'\"")})
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — loader/index failure
                logger.exception("fleet frontend failure on %s", self.path)
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet: route through logging
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


def create_fleet_server(
    registry: ModelRegistry, host: str = "127.0.0.1", port: int = 8000,
    result_timeout_s: float = 30.0, promote_loader=None, metrics_fn=None,
    neighbors_max_k: int = DEFAULT_NEIGHBORS_MAX_K,
) -> ThreadingHTTPServer:
    handler = make_fleet_handler(
        registry, result_timeout_s=result_timeout_s,
        promote_loader=promote_loader, metrics_fn=metrics_fn,
        neighbors_max_k=neighbors_max_k,
    )
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def fleet_metrics_fn(registry: ModelRegistry, latency=None):
    """Prometheus exposition for the fleet frontend.

    Two layers: (1) UNLABELED ``serve_batcher_*`` gauges aggregated across
    models — sums for queue/inflight/throughput counters, max for
    occupancy, min for ``last_completion_age_s`` (any model completing is
    fleet progress) — because the replica supervisor's parser
    (supervise.observe.parse_prometheus_text) reads only plain lines; and
    (2) per-model LABELED series for operators."""
    from simclr_pytorch_distributed_tpu_torch.utils import prom

    SUM_KEYS = (
        "submitted", "rejected", "timeouts", "batches", "batched_images",
        "dispatched_batches", "errors", "queue_depth", "queued_images",
        "inflight_batches", "inflight_rows",
    )

    def metrics() -> str:
        stats = registry.stats()
        models = stats["models"]
        agg = {key: 0.0 for key in SUM_KEYS}
        occ = 0.0
        age = None
        samples = []
        for name, entry in sorted(models.items()):
            bs = entry["batcher"]
            for key in SUM_KEYS:
                agg[key] += bs.get(key, 0)
            occ = max(occ, bs.get("pipeline_occupancy", 0.0))
            a = bs.get("last_completion_age_s")
            if a is not None:
                age = a if age is None else min(age, a)
            samples.append((
                "serve_fleet_model_queue_depth", {"model": name},
                bs.get("queue_depth", 0),
            ))
            samples.append((
                "serve_fleet_model_serving_version", {"model": name},
                entry["serving"],
            ))
            if "index" in entry:
                idx = entry["index"]
                # the full retrieval surface, per model: corpus size, LRU
                # churn, query volume, and the IVF probe/retrain counters
                # (0 on the brute rung — a recall degradation with the
                # retrain counter STUCK is the quantizer-drift failure
                # trail)
                for gauge, key in (
                    ("serve_fleet_index_entries", "entries"),
                    ("serve_fleet_index_inserts_total", "inserts"),
                    ("serve_fleet_index_evictions_total", "evictions"),
                    ("serve_fleet_index_queries_total", "queries"),
                    ("serve_fleet_index_probes_total", "probes"),
                    ("serve_fleet_index_retrains_total", "retrains"),
                ):
                    samples.append((gauge, {"model": name}, idx.get(key, 0)))
        for key in SUM_KEYS:
            samples.append((f"serve_batcher_{key}", None, agg[key]))
        samples.append(("serve_batcher_pipeline_occupancy", None, occ))
        if age is not None:
            samples.append(("serve_batcher_last_completion_age_s", None, age))
        samples.append(("serve_fleet_models", None, len(models)))
        adm = stats["admission"]
        samples.append(("serve_fleet_admission_rejected_total", None,
                        adm["rejected"]))
        samples.append(("serve_fleet_admission_outstanding_rows", None,
                        adm["outstanding_rows"]))
        if latency is not None:
            samples.extend(latency.samples("serve_request_latency_ms"))
        return prom.render_prometheus(samples)

    return metrics


def build_parser():
    from simclr_pytorch_distributed_tpu_torch.serve.server import (
        build_parser as build_serve_parser,
    )

    p = build_serve_parser()
    p.description = (
        "multi-model embedding fleet frontend (POST /embed with routing, "
        "POST /models/promote hot-swap, POST /neighbors retrieval)"
    )
    p.add_argument("--name", default="default",
                   help="name the initial model is hosted under "
                        "(/embed routes here by default)")
    p.add_argument("--index_capacity", type=int, default=4096,
                   help="per-model retrieval index rows (LRU-evicted); "
                        "0 disables /neighbors")
    p.add_argument("--retrieval_impl", default="auto",
                   choices=("brute", "ivf", "auto"),
                   help="/neighbors index implementation (the --loss_impl "
                        "ladder): brute = exact cosine over every row, "
                        "ivf = k-means inverted lists scanning only "
                        "--ivf_nprobe of them, auto = ivf above a "
                        "corpus-size threshold")
    p.add_argument("--ivf_nlist", type=int, default=0,
                   help="IVF coarse-quantizer centroids; 0 = "
                        "sqrt(index_capacity), clamped")
    p.add_argument("--ivf_nprobe", type=int, default=ivf.DEFAULT_NPROBE,
                   help="IVF lists scanned per query: the recall/latency "
                        "dial")
    p.add_argument("--neighbors_max_k", type=int,
                   default=DEFAULT_NEIGHBORS_MAX_K,
                   help="reject /neighbors k above this with 400 (the "
                        "index answers min(k, entries), so an unbounded k "
                        "dumps the whole index); 0 disables the bound")
    p.add_argument("--tenant_quota_rows", type=int, default=0,
                   help="admission control: max outstanding rows per "
                        "(model, tenant); 0 disables the layer")
    return p


def build_fleet_stack(args):
    """Registry + initial model + HTTP server from parsed args — the fleet
    analogue of serve.server.build_stack, split out so tests and embedders
    drive the exact CLI stack without serve_forever."""
    from simclr_pytorch_distributed_tpu_torch import config
    from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache
    from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine
    from simclr_pytorch_distributed_tpu_torch.utils import prom

    buckets = tuple(int(b) for b in args.buckets.split(","))
    # one cache per model NAME, shared across its versions: the identity
    # stamped into the key prefix is what keeps post-swap hits correct
    caches = {}

    def engine_kwargs(name):
        if args.cache_capacity and name not in caches:
            caches[name] = EmbeddingCache(args.cache_capacity)
        kwargs = dict(buckets=buckets, normalize=args.normalize,
                      output=args.output, cache=caches.get(name),
                      dtype=args.dtype, device=args.device)
        if args.img_size is not None:
            kwargs["img_size"] = args.img_size
        return kwargs

    def loader(name, ckpt):
        return EmbeddingEngine.from_checkpoint(ckpt, **engine_kwargs(name))

    # the --retrieval_impl ladder (the --loss_impl/--conv_impl convention):
    # resolve ONCE at startup, honored-or-raise for explicit asks, and say
    # why in the banner — the impl decides every /neighbors latency number
    impl, reason = ivf.resolve_retrieval_impl(
        args.retrieval_impl, args.index_capacity, args.ivf_nlist
    )
    logging.info(config.impl_resolution_banner(
        "retrieval_impl", args.retrieval_impl, impl, reason
    ))
    index_factory = None
    if impl == "ivf":
        index_factory = lambda dim: ivf.IVFIndex(  # noqa: E731
            dim, capacity=args.index_capacity, nlist=args.ivf_nlist,
            nprobe=args.ivf_nprobe,
        )

    latency = prom.LatencyHistogram()
    registry = ModelRegistry(
        batcher_kwargs=dict(
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue, max_inflight=args.max_inflight,
            max_inflight_images=args.max_inflight_images, latency=latency,
        ),
        admission=AdmissionController(args.tenant_quota_rows),
        index_capacity=args.index_capacity,
        index_factory=index_factory,
    )
    if args.ckpt:
        engine = loader(args.name, args.ckpt)
    else:
        logging.warning("--ckpt not given: serving a RANDOM %s", args.model)
        kwargs = engine_kwargs(args.name)
        engine = EmbeddingEngine.random_init(
            model_name=args.model, size=kwargs.get("img_size", 32), **kwargs
        )
    registry.add_model(args.name, engine, source=args.ckpt or "random")
    server = create_fleet_server(
        registry, host=args.host, port=args.port, promote_loader=loader,
        metrics_fn=fleet_metrics_fn(registry, latency),
        neighbors_max_k=args.neighbors_max_k,
    )
    return registry, server


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
    registry, server = build_fleet_stack(args)
    logging.info("fleet frontend: model %r on http://%s:%d",
                 args.name, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        registry.close()
        tracing.uninstall()
        if recorder is not None:
            recorder.close()


# re-exported so embedders have one import site for "run a fleet frontend"
__all__ = [
    "make_fleet_handler", "create_fleet_server", "fleet_metrics_fn",
    "build_parser", "build_fleet_stack", "main", "start_in_thread",
]
