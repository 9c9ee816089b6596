"""ModelRegistry — N named checkpoint versions behind one server.

The port of the JAX package's ``serve/fleet/registry.py``. Each engine is
the port's ``EmbeddingEngine`` on its device, and each model's retrieval
index scores on that engine's device.

One registry hosts many NAMED models; each name hosts a chain of VERSIONS
(v1, v2, ... — one per promote). The pieces compose, they are not rebuilt:

- every version is an ordinary :class:`~serve.engine.EmbeddingEngine` with
  its own weights on the device, all sharing the one card;
- every NAME has exactly ONE :class:`~serve.batcher.DynamicBatcher` whose
  queue survives promotes — requests coalesced before a swap and dispatched
  after it simply route to the new serving version, which is what makes
  FIFO ordering across a swap free (the completer was already strictly
  FIFO in dispatch order);
- routing: ``submit(images, model=...)`` picks the name (default = the
  newest promoted name), per-tenant admission quotas layer on top of the
  batcher's own QueueFull/row-bounded backpressure.

**Hot-swap drain (the dispatch/completion split as the swap seam).** A
dispatch pins the CURRENT serving version — its in-flight counter is
incremented under the registry lock BEFORE the engine call, so a promote
landing one instruction later can only mark it ``draining``, never retire
it. Completion (:class:`_TrackedBatch.result`) releases the pin; the last
release of a draining version retires it: the engine reference is dropped
(device buffers freed), the ``drained`` event fires, and a
``model_retired`` tracing event lands in the flight recorder. No request
is ever failed or rerouted by a promote: everything dispatched before the
swap completes on the old engine, everything after dispatches on the new
one. The tests hold a gated batch in flight across a promote to pin
exactly this.

Cache identity: the registry stamps ``"<name>@v<version>"`` into each
engine's cache-key prefix (``EmbeddingEngine.set_identity``) before the
version becomes visible, so a shared EmbeddingCache can never serve a
retired version's rows — even byte-identical weights miss after a swap.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from simclr_pytorch_distributed_tpu_torch.serve.batcher import DynamicBatcher, QueueFull
from simclr_pytorch_distributed_tpu_torch.serve.fleet.retrieval import NeighborIndex
from simclr_pytorch_distributed_tpu_torch.utils import tracing

SERVING = "serving"
DRAINING = "draining"
RETIRED = "retired"


class ModelVersion:
    """One hosted checkpoint version: the engine plus its drain state."""

    def __init__(self, name: str, version: int, engine, source: str = ""):
        self.name = name
        self.version = version
        self.engine = engine
        self.source = source
        self.state = SERVING
        self.inflight = 0  # dispatched-but-uncompleted batches pinning us
        self.drained = threading.Event()

    @property
    def identity(self) -> str:
        return f"{self.name}@v{self.version}"

    def info(self) -> dict:
        return {
            "version": self.version,
            "state": self.state,
            "inflight": self.inflight,
            "source": self.source,
        }


class _TrackedBatch:
    """An engine ``InflightBatch`` that releases its version pin on
    completion. ``result()`` stays idempotent, and the release happens
    exactly once whether the completion succeeds or raises (a failed D2H
    still ends the engine's involvement — holding the pin would wedge the
    drain forever)."""

    def __init__(self, registry: "ModelRegistry", mv: ModelVersion, handle):
        self._registry = registry
        self._mv = mv
        self._handle = handle
        self._released = False
        self._lock = threading.Lock()

    @property
    def n_rows(self) -> int:
        return self._handle.n_rows

    def done(self) -> bool:
        return self._handle.done()

    def result(self) -> np.ndarray:
        try:
            return self._handle.result()
        finally:
            with self._lock:
                release, self._released = not self._released, True
            if release:
                self._registry._release(self._mv)


class AdmissionController:
    """Per-(model, tenant) outstanding-row quotas over the shared queue.

    The batcher's QueueFull bounds TOTAL queue memory; it cannot stop one
    tenant from filling it and starving the rest. ``admit`` charges the
    request's rows against its (model, tenant) bucket and raises
    :class:`~serve.batcher.QueueFull` over quota — same exception, same 503
    + Retry-After on the wire — and the returned release callable (hung on
    the request future's done-callback) refunds the rows whichever way the
    request ends. ``max_tenant_rows <= 0`` disables the layer."""

    def __init__(self, max_tenant_rows: int = 0):
        self.max_tenant_rows = int(max_tenant_rows)
        self._outstanding: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._admitted = 0
        self._rejected = 0

    def admit(self, model: str, tenant: str, n: int) -> Callable[[], None]:
        if self.max_tenant_rows <= 0:
            return lambda: None
        key = (model, tenant)
        with self._lock:
            held = self._outstanding.get(key, 0)
            if held + n > self.max_tenant_rows:
                self._rejected += 1
                raise QueueFull(
                    f"tenant {tenant!r} over quota on model {model!r} "
                    f"({held} rows outstanding, quota {self.max_tenant_rows})"
                )
            self._outstanding[key] = held + n
            self._admitted += 1
        released = threading.Event()

        def release() -> None:
            if released.is_set():
                return
            released.set()
            with self._lock:
                left = self._outstanding.get(key, 0) - n
                if left > 0:
                    self._outstanding[key] = left
                else:
                    self._outstanding.pop(key, None)

        return release

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_tenant_rows": self.max_tenant_rows,
                "admitted": self._admitted,
                "rejected": self._rejected,
                "active_buckets": len(self._outstanding),
                "outstanding_rows": sum(self._outstanding.values()),
            }


class _ModelState:
    """Everything one NAME owns: its batcher (queue survives promotes),
    its version chain, and its retrieval index."""

    def __init__(self, name: str, batcher: DynamicBatcher,
                 serving: ModelVersion, index: Optional[NeighborIndex]):
        self.name = name
        self.batcher = batcher
        self.versions: List[ModelVersion] = [serving]
        self.serving = serving
        self.index = index


class ModelRegistry:
    def __init__(
        self,
        *,
        batcher_kwargs: Optional[dict] = None,
        admission: Optional[AdmissionController] = None,
        index_capacity: int = 4096,
        index_factory: Optional[Callable[[int], object]] = None,
    ):
        # one lock orders every routing/promote/drain transition; engine
        # dispatches run OUTSIDE it (they take the engine's own lock and
        # block on host work — serializing models against each other here
        # would defeat multi-model hosting)
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelState] = {}
        self._default: Optional[str] = None
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self.admission = admission if admission is not None else AdmissionController()
        self._index_capacity = int(index_capacity)
        # feat_dim -> index; the registry is impl-blind — the frontend's
        # --retrieval_impl ladder decides brute vs IVF (serve/fleet/ivf.py)
        # and hands the constructor down here
        self._index_factory = index_factory
        self._closed = False

    # ----------------------------------------------------------- lifecycle

    def add_model(self, name: str, engine, source: str = "") -> ModelVersion:
        """Host a new NAME at version 1 and make it the default route."""
        mv = ModelVersion(name, 1, engine, source)
        engine.set_identity(mv.identity)
        index = self._new_index(engine)
        batcher = DynamicBatcher(
            dispatch_fn=lambda images, _n=name: self._dispatch(_n, images),
            # both closures track the CURRENT serving version: a promote
            # retargets queued-but-undispatched requests automatically
            validate=lambda images, _n=name: self._serving(_n).validate_images(images),
            bucket_fn=lambda n, _n=name: self._serving(_n).bucket_for(n),
            **self._batcher_kwargs,
        )
        with self._lock:
            if self._closed:
                batcher.close(drain=False)
                raise RuntimeError("ModelRegistry is closed")
            if name in self._models:
                batcher.close(drain=False)
                raise ValueError(f"model {name!r} already hosted")
            self._models[name] = _ModelState(name, batcher, mv, index)
            self._default = name
        tracing.event(
            "model_added", track="serve:fleet", model=name, version=1,
            source=source,
        )
        return mv

    def _new_index(self, engine):
        """An empty retrieval index for ``engine``'s rows (its width, on its
        device), or ``None`` with ``index_capacity`` 0."""
        if self._index_capacity <= 0:
            return None
        if self._index_factory is not None:
            return self._index_factory(engine.feat_dim)
        return NeighborIndex(engine.feat_dim, capacity=self._index_capacity,
                             device=getattr(engine, "device", "cuda"))

    def promote(self, name: str, engine, source: str = "") -> ModelVersion:
        """Install ``engine`` as ``name``'s next version; the old version
        drains (completes everything already dispatched on it) and retires
        on its last completion. Returns the new version. The swap is
        atomic under the registry lock: no request observes a moment with
        no serving version."""
        with self._lock:
            st = self._models.get(name)
            if st is None:
                raise KeyError(f"unknown model {name!r}")
            old = st.serving
            mv = ModelVersion(name, old.version + 1, engine, source)
            # stamp the cache identity BEFORE the version is visible: the
            # first post-swap request must already key on name@vN+1
            engine.set_identity(mv.identity)
            st.versions.append(mv)
            st.serving = mv
            old.state = DRAINING
            self._default = name
            if st.index is not None:
                # a new version is a new embedding space: neighbors
                # computed by v_old are not comparable to v_new queries.
                # A new index, not a cleared one: the new checkpoint's rows
                # may be of another width (the JAX registry clears the old
                # index, and /embed then fails on a width change)
                st.index = self._new_index(engine)
        tracing.event(
            "model_promote", track="serve:fleet", model=name,
            version=mv.version, draining=old.version, source=source,
        )
        with self._lock:
            self._maybe_retire_locked(old)
        return mv

    def close(self) -> None:
        """Drain every model's batcher and retire every version."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            states = list(self._models.values())
        for st in states:
            st.batcher.close()  # drains: completions release every pin
        with self._lock:
            for st in states:
                for mv in st.versions:
                    if mv.state != RETIRED:
                        mv.state = DRAINING
                        self._maybe_retire_locked(mv)

    # ------------------------------------------------------------- routing

    def resolve(self, model: Optional[str]) -> str:
        """The name a request routes to (explicit, else newest promoted)."""
        with self._lock:
            name = model or self._default
            if name is None:
                raise KeyError("no models hosted")
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}")
            return name

    def _serving(self, name: str):
        with self._lock:
            st = self._models.get(name)
            if st is None:
                raise RuntimeError(f"unknown model {name!r}")
            return st.serving.engine

    def _dispatch(self, name: str, images: np.ndarray) -> _TrackedBatch:
        """The batcher's dispatch_fn: pin the current serving version, then
        run the engine's dispatch stage outside the registry lock."""
        with self._lock:
            st = self._models.get(name)
            if st is None:
                raise RuntimeError(f"unknown model {name!r}")
            mv = st.serving
            mv.inflight += 1
        try:
            handle = mv.engine.dispatch(images)
        except BaseException:
            # the pin protects work the engine OWNS; a dispatch that never
            # started owns nothing — release, or the drain never finishes
            self._release(mv)
            raise
        return _TrackedBatch(self, mv, handle)

    def _release(self, mv: ModelVersion) -> None:
        with self._lock:
            mv.inflight -= 1
            self._maybe_retire_locked(mv)

    def _maybe_retire_locked(self, mv: ModelVersion) -> None:
        if mv.state == DRAINING and mv.inflight == 0:
            mv.state = RETIRED
            mv.engine = None  # drop the weights: device memory frees
            mv.drained.set()
            tracing.event(
                "model_retired", track="serve:fleet", model=mv.name,
                version=mv.version,
            )

    def submit(
        self,
        images: np.ndarray,
        *,
        model: Optional[str] = None,
        tenant: str = "",
        timeout_ms: Optional[float] = None,
    ):
        """Route one request: ``(name, future)``. Raises ``KeyError`` for an
        unknown model (HTTP 400), :class:`QueueFull` for backpressure or an
        exhausted tenant quota (503)."""
        name = self.resolve(model)
        images = np.asarray(images)
        n = int(images.shape[0]) if images.ndim == 4 else 0
        release = self.admission.admit(name, tenant, n)
        with self._lock:
            st = self._models[name]
        try:
            future = st.batcher.submit(images, timeout_ms=timeout_ms)
        except BaseException:
            release()
            raise
        future.add_done_callback(lambda _f: release())
        return name, future

    # ----------------------------------------------------------- retrieval

    @staticmethod
    def content_id(image_u8: np.ndarray) -> str:
        """The wire-visible neighbor id: content hash of the raw image
        (shape-qualified like the embedding cache key, but with NO model
        fingerprint — the per-model index already scopes it)."""
        h = hashlib.sha1(str(image_u8.shape).encode())
        h.update(np.ascontiguousarray(image_u8).tobytes())
        return h.hexdigest()[:20]

    def index_add(self, name: str, images: np.ndarray, embeddings: np.ndarray) -> None:
        """Feed served rows into ``name``'s retrieval index (the /embed
        response path; /neighbors queries are NOT inserted, so retrieval
        reads don't mutate the corpus)."""
        with self._lock:
            st = self._models.get(name)
            index = st.index if st is not None else None
        if index is None:
            return
        keys = [self.content_id(images[i]) for i in range(images.shape[0])]
        index.add(keys, embeddings)

    def neighbors_lookup(self, name: str, embeddings: np.ndarray, k: int):
        with self._lock:
            st = self._models.get(name)
            if st is None:
                raise KeyError(f"unknown model {name!r}")
            index = st.index
        if index is None:
            raise RuntimeError("retrieval index disabled (index_capacity=0)")
        return index.query(embeddings, k)

    # --------------------------------------------------------------- views

    def default_model(self) -> Optional[str]:
        with self._lock:
            return self._default

    def batcher(self, name: str) -> DynamicBatcher:
        with self._lock:
            return self._models[name].batcher

    def wait_drained(
        self, name: str, version: int, timeout: Optional[float] = None
    ) -> bool:
        with self._lock:
            st = self._models.get(name)
            mv = None
            if st is not None:
                for v in st.versions:
                    if v.version == version:
                        mv = v
                        break
        if mv is None:
            raise KeyError(f"unknown version {name}@v{version}")
        return mv.drained.wait(timeout)

    def models_payload(self) -> dict:
        """GET /models: the routing table as clients see it."""
        with self._lock:
            return {
                "default": self._default,
                "models": {
                    name: {
                        "serving": st.serving.version,
                        "versions": [mv.info() for mv in st.versions],
                    }
                    for name, st in self._models.items()
                },
            }

    def stats(self) -> dict:
        with self._lock:
            states = list(self._models.items())
            default = self._default
        out = {"default": default, "admission": self.admission.stats(), "models": {}}
        for name, st in states:
            entry = {
                "serving": st.serving.version,
                "versions": [mv.info() for mv in st.versions],
                "batcher": st.batcher.stats(),
            }
            engine = st.serving.engine
            if engine is not None:
                entry["engine"] = engine.stats()
            if st.index is not None:
                entry["index"] = st.index.stats()
            out["models"][name] = entry
        return out
