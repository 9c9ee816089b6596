"""The port's ``serve/fleet/`` against the JAX package's, on the CPU.

- The registry, admission and HTTP-frontend bodies of
  ``tests/test_serve_fleet.py`` run on both packages' classes
  (parametrised) over per-row fake engines, whose completions an Event
  gates, so a promote provably lands while a batch is in flight: routing,
  the hot-swap drain with zero failed requests, FIFO across a swap, queued
  requests retargeting, quotas, and the endpoints' codes and keys.
- ``NeighborIndex`` against JAX's on the same rows and queries: the same
  neighbor ids, scores within 1e-6, and both against a numpy oracle.
- ``IVFIndex`` (numpy in both packages) against JAX's on the same rows and
  seed: the same centroids, lists and answers, bitwise.
- The port alone: the cache identity across a swap to byte-identical
  weights on two real engines, the CLI stack on ``--device cpu`` with a
  promote from a checkpoint, and a promote to a checkpoint of another
  width, after which ``/embed`` still answers (the JAX registry keeps the
  old index's width and answers 400 there).
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.serve import batcher as jax_batcher
from simclr_pytorch_distributed_tpu.serve import fleet as jax_fleet
from simclr_pytorch_distributed_tpu.serve import server as jax_server
from simclr_pytorch_distributed_tpu.serve.fleet import frontend as jax_frontend
from simclr_pytorch_distributed_tpu_torch.serve import batcher as port_batcher
from simclr_pytorch_distributed_tpu_torch.serve import fleet as port_fleet
from simclr_pytorch_distributed_tpu_torch.serve import server as port_server
from simclr_pytorch_distributed_tpu_torch.serve.fleet import frontend as port_frontend
from torch_threads import limit_threads

limit_threads()

PACKAGES = {
    "jax": types.SimpleNamespace(batcher=jax_batcher, fleet=jax_fleet, server=jax_server,
                                 frontend=jax_frontend),
    "port": types.SimpleNamespace(batcher=port_batcher, fleet=port_fleet, server=port_server,
                                  frontend=port_frontend),
}

H = W = 2


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def imgs(*values):
    out = np.zeros((len(values), H, W, 3), np.uint8)
    for i, v in enumerate(values):
        out[i] = v
    return out


class FakeHandle:
    def __init__(self, engine, images):
        self._engine = engine
        self._images = images
        self.n_rows = len(images)

    def done(self):
        gate = self._engine.gate
        return gate is None or gate.is_set()

    def result(self):
        gate = self._engine.gate
        if gate is not None:
            assert gate.wait(30), "test gate never opened"
        return self._engine.rows(self._images)


class FakeEngine:
    """Per-row map with the engine's dispatch surface; ``scale`` tells the
    versions apart, ``gate`` holds every completion until released. On the
    CPU (the port's retrieval index scores on the engine's device)."""

    feat_dim = 3
    device = torch.device("cpu")

    def __init__(self, scale=1.0, gate=None):
        self.scale = scale
        self.gate = gate
        self.identity = ""

    def set_identity(self, identity):
        self.identity = identity

    def rows(self, images):
        v = np.asarray(images, np.float32).reshape(len(images), -1)[:, :1] + 1.0
        return np.hstack([v, v ** 2, np.ones_like(v)]) * self.scale

    def validate_images(self, images):
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[0] == 0:
            raise ValueError("need a non-empty [N,H,W,3] batch")
        return images

    def bucket_for(self, n):
        return n

    def dispatch(self, images):
        return FakeHandle(self, images)

    def stats(self):
        return {"identity": self.identity, "fake": True}


def make_registry(pkg, **kwargs):
    kwargs.setdefault("batcher_kwargs", {"max_wait_ms": 1})
    kwargs.setdefault("index_capacity", 0)
    return pkg.fleet.ModelRegistry(**kwargs)


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.002)
    return False


# ------------------------------------------------------------ registry core


def test_routing_default_and_explicit(pkg):
    reg = make_registry(pkg)
    try:
        reg.add_model("prod", FakeEngine(scale=1.0))
        reg.add_model("exp", FakeEngine(scale=10.0))
        assert reg.default_model() == "exp"
        x = imgs(2)
        name, fut = reg.submit(x)
        assert name == "exp"
        np.testing.assert_array_equal(fut.result(5), FakeEngine(10.0).rows(x))
        name, fut = reg.submit(x, model="prod")
        assert name == "prod"
        np.testing.assert_array_equal(fut.result(5), FakeEngine(1.0).rows(x))
    finally:
        reg.close()


def test_duplicate_and_unknown_models(pkg):
    reg = make_registry(pkg)
    try:
        reg.add_model("m", FakeEngine())
        with pytest.raises(ValueError, match="already hosted"):
            reg.add_model("m", FakeEngine())
        with pytest.raises(KeyError):
            reg.submit(imgs(1), model="nope")
        with pytest.raises(KeyError):
            reg.promote("nope", FakeEngine())
        with pytest.raises(KeyError):
            reg.wait_drained("m", 7, timeout=0)
    finally:
        reg.close()
    with pytest.raises(RuntimeError, match="closed"):
        reg.add_model("late", FakeEngine())


def test_submit_with_no_models_is_keyerror(pkg):
    reg = make_registry(pkg)
    try:
        with pytest.raises(KeyError, match="no models"):
            reg.submit(imgs(1))
    finally:
        reg.close()


def test_hot_swap_drains_inflight_on_old_engine(pkg):
    gate = threading.Event()
    old = FakeEngine(scale=1.0, gate=gate)
    reg = make_registry(pkg)
    try:
        mv1 = reg.add_model("m", old)
        assert old.identity == "m@v1"
        x1 = imgs(3, 4)
        _, f1 = reg.submit(x1)
        assert wait_for(lambda: mv1.inflight > 0)
        new = FakeEngine(scale=5.0)
        mv2 = reg.promote("m", new)
        assert (mv1.state, mv2.state) == ("draining", "serving")
        assert new.identity == "m@v2"
        assert not reg.wait_drained("m", 1, timeout=0.05)
        assert not f1.done()
        x2 = imgs(7)
        _, f2 = reg.submit(x2)
        gate.set()
        np.testing.assert_array_equal(f1.result(5), old.rows(x1))
        np.testing.assert_array_equal(f2.result(5), new.rows(x2))
        assert reg.wait_drained("m", 1, timeout=5)
        assert mv1.state == "retired" and mv1.engine is None
        s = reg.stats()["models"]["m"]
        assert s["batcher"]["errors"] == 0 and s["batcher"]["timeouts"] == 0
        assert s["serving"] == 2
        assert [v["state"] for v in s["versions"]] == ["retired", "serving"]
    finally:
        reg.close()


def test_fifo_holds_across_the_swap(pkg):
    gate = threading.Event()
    reg = make_registry(pkg)
    try:
        mv1 = reg.add_model("m", FakeEngine(scale=1.0, gate=gate))
        order = []
        _, f1 = reg.submit(imgs(1))
        f1.add_done_callback(lambda _f: order.append(1))
        assert wait_for(lambda: mv1.inflight > 0)
        reg.promote("m", FakeEngine(scale=2.0))
        _, f2 = reg.submit(imgs(2))
        f2.add_done_callback(lambda _f: order.append(2))
        time.sleep(0.05)
        assert not f2.done() and order == []
        gate.set()
        f2.result(5)
        assert wait_for(lambda: len(order) == 2)
        assert order == [1, 2]
    finally:
        reg.close()


def test_queued_requests_retarget_to_the_new_version(pkg):
    reg = pkg.fleet.ModelRegistry(batcher_kwargs={"max_wait_ms": 1, "start": False},
                                  index_capacity=0)
    try:
        reg.add_model("m", FakeEngine(scale=1.0))
        x = imgs(6)
        _, fut = reg.submit(x)
        mv2 = reg.promote("m", FakeEngine(scale=3.0))
        b = reg.batcher("m")
        b._dispatch(b._next_batch())
        np.testing.assert_array_equal(fut.result(5), FakeEngine(3.0).rows(x))
        assert mv2.inflight == 0
        assert reg.wait_drained("m", 1, timeout=5)
    finally:
        reg.close()


def test_promote_under_load_fails_no_request(pkg):
    """Clients submit continuously while the model is promoted twice: every
    request completes, on the version serving when it was dispatched."""
    reg = make_registry(pkg)
    reg.add_model("m", FakeEngine(scale=1.0))
    stop = threading.Event()
    results, errors = [], []

    def client(c):
        k = 0
        while not stop.is_set():
            try:
                _, fut = reg.submit(imgs((c * 50 + k) % 200))
                results.append(fut.result(10))
            except Exception as e:  # noqa: BLE001 - counted below
                errors.append(e)
            k += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        assert wait_for(lambda: len(results) > 20)
        reg.promote("m", FakeEngine(scale=2.0))
        n = len(results)
        assert wait_for(lambda: len(results) > n + 20)
        reg.promote("m", FakeEngine(scale=3.0))
        n = len(results)
        assert wait_for(lambda: len(results) > n + 20)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        reg.close()
    assert not errors
    assert reg.wait_drained("m", 1, timeout=5) and reg.wait_drained("m", 2, timeout=5)
    assert {float(r[0, 2]) for r in results} <= {1.0, 2.0, 3.0}


# ------------------------------------------------------------------ admission


def test_admission_controller_quota_and_release(pkg):
    adm = pkg.fleet.AdmissionController(max_tenant_rows=4)
    rel_a = adm.admit("m", "a", 3)
    adm.admit("m", "b", 4)
    with pytest.raises(pkg.batcher.QueueFull, match="tenant"):
        adm.admit("m", "a", 2)
    rel_a()
    adm.admit("m", "a", 4)
    s = adm.stats()
    assert s["rejected"] == 1 and s["admitted"] == 3
    assert pkg.fleet.AdmissionController(0).admit("m", "t", 10 ** 6)() is None


def test_admission_releases_when_the_future_resolves(pkg):
    gate = threading.Event()
    reg = pkg.fleet.ModelRegistry(batcher_kwargs={"max_wait_ms": 1},
                                  admission=pkg.fleet.AdmissionController(max_tenant_rows=2),
                                  index_capacity=0)
    try:
        reg.add_model("m", FakeEngine(gate=gate))
        _, f1 = reg.submit(imgs(1, 2), tenant="t")
        with pytest.raises(pkg.batcher.QueueFull):
            reg.submit(imgs(3), tenant="t")
        _, f_other = reg.submit(imgs(3), tenant="u")
        gate.set()
        f1.result(5)
        f_other.result(5)
        assert wait_for(lambda: reg.admission.stats()["outstanding_rows"] == 0)
        _, f2 = reg.submit(imgs(4, 5), tenant="t")
        f2.result(5)
    finally:
        reg.close()


# ------------------------------------------------------------------ retrieval


def test_neighbor_index_matches_jax_and_the_numpy_oracle():
    dim, n = 16, 40
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(n, dim)).astype(np.float32)
    keys = [f"k{i}" for i in range(n)]
    queries = rng.normal(size=(37, dim)).astype(np.float32)  # two query chunks
    got = {}
    for name, pkg in PACKAGES.items():
        kwargs = {"device": "cpu"} if name == "port" else {}
        index = pkg.fleet.NeighborIndex(dim, capacity=64, **kwargs)
        index.add(keys, rows)
        got[name] = index.query(queries, k=7)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    q_unit = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    scores = q_unit @ unit.T
    for qi, (hits_p, hits_j) in enumerate(zip(got["port"], got["jax"])):
        assert [k for k, _ in hits_p] == [k for k, _ in hits_j]
        np.testing.assert_allclose([s for _, s in hits_p], [s for _, s in hits_j],
                                   rtol=0, atol=1e-6)
        oracle = np.argsort(-scores[qi])[:7]
        assert [k for k, _ in hits_p] == [keys[j] for j in oracle]


def test_port_neighbor_index_breaks_ties_by_slot():
    """Equal scores come back in slot (insertion) order, the numpy stable
    oracle's, whatever argpartition picks among them: chip_smoke.py's
    serve (c) compares the ids with that oracle. 48 copies of one row and
    16 of another leave every query full of ties."""
    rows = np.repeat(np.eye(4, dtype=np.float32)[:2], [48, 16], axis=0)
    keys = [f"k{i}" for i in range(len(rows))]
    index = port_fleet.NeighborIndex(4, capacity=64, device="cpu")
    index.add(keys, rows)
    queries = np.array([[1, 0, 0, 0], [0.6, 0.8, 0, 0], [0, 1, 0, 0]], np.float32)
    scores = queries @ rows.T / np.linalg.norm(queries, axis=1, keepdims=True)
    for k in (1, 5, 20, 50):
        for qi, hits in enumerate(index.query(queries, k=k)):
            oracle = np.argsort(-scores[qi], kind="stable")[:k]
            assert [key for key, _ in hits] == [keys[j] for j in oracle], (k, qi)


def test_neighbor_index_lru_eviction_and_update_refresh(pkg):
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(6, 4)).astype(np.float32)
    kwargs = {"device": "cpu"} if pkg is PACKAGES["port"] else {}
    index = pkg.fleet.NeighborIndex(4, capacity=4, **kwargs)
    index.add([f"k{i}" for i in range(4)], rows[:4])
    index.add(["k0"], rows[4:5])
    index.add(["k4"], rows[5:6])
    assert len(index) == 4
    held = {key for key, _ in index.query(rows[0:1], k=4)[0]}
    assert held == {"k0", "k2", "k3", "k4"}
    s = index.stats()
    assert s["evictions"] == 1 and s["updates"] == 1 and s["inserts"] == 5
    top_key, top_score = index.query(rows[4:5], k=1)[0][0]
    assert top_key == "k0" and top_score == pytest.approx(1.0, abs=1e-5)


def test_neighbor_index_empty_clear_and_small_k(pkg):
    kwargs = {"device": "cpu"} if pkg is PACKAGES["port"] else {}
    index = pkg.fleet.NeighborIndex(4, capacity=8, **kwargs)
    assert index.query(np.ones((2, 4), np.float32), k=3) == [[], []]
    index.add(["a", "b"], np.eye(4, dtype=np.float32)[:2])
    got = index.query(np.eye(4, dtype=np.float32)[:1], k=10)[0]
    assert [k for k, _ in got] == ["a", "b"]
    index.clear()
    assert len(index) == 0
    assert index.query(np.ones((1, 4), np.float32), k=1) == [[]]
    with pytest.raises(ValueError):
        index.query(np.ones((1, 4), np.float32), k=0)


def test_ivf_index_matches_jax_bitwise():
    """Both packages' IVF (numpy) on the same rows, inserts and seed: the
    same centroids, the same lists in the same order, the same answers."""
    rng = np.random.default_rng(3)
    dim = 8
    centers = rng.normal(size=(6, dim))
    rows = (centers[rng.integers(0, 6, 700)] + 0.3 * rng.normal(size=(700, dim)))
    rows = rows.astype(np.float32)
    keys = [f"k{i}" for i in range(len(rows))]
    queries = rows[:20] + 0.05 * rng.normal(size=(20, dim)).astype(np.float32)
    indexes = {}
    for name, pkg in PACKAGES.items():
        ivf = pkg.fleet.IVFIndex(dim, capacity=512, nlist=8, nprobe=3, seed=5,
                                 train_min_rows=128)
        for lo in range(0, len(rows), 50):
            ivf.add(keys[lo:lo + 50], rows[lo:lo + 50])
        ivf.add(keys[:10], rows[100:110])  # updates that may move lists
        indexes[name] = (ivf, ivf.query(queries, k=6))
    (jivf, jhits), (pivf, phits) = indexes["jax"], indexes["port"]
    assert phits == jhits
    np.testing.assert_array_equal(pivf._centroids, jivf._centroids)
    assert [list(lst.items()) for lst in pivf._lists] == [list(lst.items()) for lst in
                                                           jivf._lists]
    np.testing.assert_array_equal(pivf._buf, jivf._buf)
    assert pivf.stats() == jivf.stats() and pivf.stats()["retrains"] >= 2


@pytest.mark.parametrize("impl,capacity,nlist", [
    ("auto", 4096, 0), ("auto", 40000, 0), ("brute", 100, 0), ("ivf", 4096, 16),
    ("ivf", 8, 16), ("ivf", 0, 0), ("brute", 0, 0), ("nope", 10, 0),
])
def test_retrieval_ladder_matches_jax(impl, capacity, nlist):
    answers = []
    for pkg in PACKAGES.values():
        try:
            answers.append(pkg.fleet.resolve_retrieval_impl(impl, capacity, nlist))
        except ValueError as e:
            answers.append(("raises", str(e)))
    assert answers[0] == answers[1]
    assert port_fleet.ivf.auto_nlist(capacity) == jax_fleet.ivf.auto_nlist(capacity)


# ------------------------------------------------------------- HTTP frontend


def post(base, path, obj, timeout=10):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get_raw(base, path, timeout=10):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return r.status, r.read().decode()


def start(pkg, reg, **kwargs):
    server = pkg.frontend.create_fleet_server(reg, port=0, **kwargs)
    pkg.server.start_in_thread(server)
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture()
def fleet(pkg):
    reg = pkg.fleet.ModelRegistry(batcher_kwargs={"max_wait_ms": 1},
                                  admission=pkg.fleet.AdmissionController(max_tenant_rows=0),
                                  index_capacity=16)
    reg.add_model("exp", FakeEngine(scale=10.0))
    reg.add_model("prod", FakeEngine(scale=1.0))
    loads = []

    def loader(name, ckpt):
        loads.append((name, ckpt))
        return FakeEngine(scale=5.0)

    server, base = start(pkg, reg, promote_loader=loader,
                         metrics_fn=pkg.frontend.fleet_metrics_fn(reg))
    yield base, reg, loads
    stop(server)
    reg.close()


@pytest.fixture()
def fleet_ivf(pkg):
    reg = pkg.fleet.ModelRegistry(
        batcher_kwargs={"max_wait_ms": 1},
        admission=pkg.fleet.AdmissionController(max_tenant_rows=0), index_capacity=16,
        index_factory=lambda dim: pkg.fleet.IVFIndex(dim, capacity=16, nlist=2, nprobe=2,
                                                     train_min_rows=1000))
    reg.add_model("prod", FakeEngine(scale=1.0))
    server, base = start(pkg, reg, metrics_fn=pkg.frontend.fleet_metrics_fn(reg))
    yield base, reg
    stop(server)
    reg.close()


def test_http_embed_routes_and_defaults(fleet):
    base, _, _ = fleet
    x = imgs(3)
    status, r = post(base, "/embed", {"images": x.tolist()})
    assert status == 200 and r["model"] == "prod"
    np.testing.assert_allclose(r["embeddings"], FakeEngine(1.0).rows(x))
    status, r = post(base, "/embed", {"images": x.tolist(), "model": "exp"})
    assert r["model"] == "exp"
    np.testing.assert_allclose(r["embeddings"], FakeEngine(10.0).rows(x))
    assert r["dim"] == 3 and r["n"] == 1


def test_http_unknown_model_and_bad_inputs_400(fleet):
    base, _, _ = fleet
    for body in ({"images": imgs(1).tolist(), "model": "nope"},
                 {"images": imgs(1).tolist(), "model": 7},
                 {"images": [[1]]},
                 {"images": imgs(1).tolist(), "tenant": 3}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/embed", body)
        assert exc.value.code == 400


def test_http_neighbors_roundtrip(fleet):
    base, reg, _ = fleet
    post(base, "/embed", {"images": imgs(10, 20, 30).tolist()})
    status, r = post(base, "/neighbors", {"images": imgs(20).tolist(), "k": 2})
    assert status == 200 and r["model"] == "prod" and r["k"] == 2
    hits = r["neighbors"][0]
    assert len(hits) == 2
    assert hits[0]["id"] == reg.content_id(imgs(20)[0])
    assert hits[0]["score"] == pytest.approx(1.0, abs=1e-5)
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(base, "/neighbors", {"images": imgs(1).tolist(), "k": 0})
    assert exc.value.code == 400


def test_http_neighbors_k_bounded_by_max_k(fleet):
    base, _, _ = fleet
    post(base, "/embed", {"images": imgs(7).tolist()})
    status, r = post(base, "/neighbors", {"images": imgs(7).tolist(), "k": 100})
    assert status == 200 and len(r["neighbors"][0]) == 1
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(base, "/neighbors", {"images": imgs(7).tolist(), "k": 101})
    assert exc.value.code == 400
    assert "neighbors_max_k" in json.loads(exc.value.read())["error"]


def test_http_neighbors_max_k_disabled(pkg):
    reg = make_registry(pkg, index_capacity=8)
    reg.add_model("m", FakeEngine())
    server, base = start(pkg, reg, neighbors_max_k=0)
    try:
        post(base, "/embed", {"images": imgs(1).tolist()})
        status, r = post(base, "/neighbors", {"images": imgs(1).tolist(), "k": 5000})
        assert status == 200 and len(r["neighbors"][0]) == 1
    finally:
        stop(server)
        reg.close()


def test_http_neighbors_roundtrip_on_ivf_index(fleet_ivf):
    base, reg = fleet_ivf
    post(base, "/embed", {"images": imgs(10, 20, 30).tolist()})
    status, r = post(base, "/neighbors", {"images": imgs(20).tolist(), "k": 2})
    assert status == 200 and r["k"] == 2
    hits = r["neighbors"][0]
    assert hits[0]["id"] == reg.content_id(imgs(20)[0])
    assert hits[0]["score"] == pytest.approx(1.0, abs=1e-5)
    reg.promote(r["model"], FakeEngine(scale=2.0))
    stats = reg.stats()["models"][r["model"]]["index"]
    assert stats["entries"] == 0 and stats["trained_lists"] == 0


def test_http_promote_swaps_and_drains(fleet):
    base, reg, loads = fleet
    x = imgs(4)
    status, r = post(base, "/models/promote", {"model": "prod", "ckpt": "/fake/ckpt"})
    assert status == 200
    assert r == {"model": "prod", "version": 2, "draining": 1}
    assert loads == [("prod", "/fake/ckpt")]
    assert reg.wait_drained("prod", 1, timeout=5)
    _, r = post(base, "/embed", {"images": x.tolist(), "model": "prod"})
    np.testing.assert_allclose(r["embeddings"], FakeEngine(5.0).rows(x))
    _, payload = get_raw(base, "/models")
    models = json.loads(payload)["models"]
    assert [v["state"] for v in models["prod"]["versions"]] == ["retired", "serving"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(base, "/models/promote", {"model": "ghost", "ckpt": "/x"})
    assert exc.value.code == 400


def test_http_promote_without_loader_is_503(pkg):
    reg = make_registry(pkg)
    reg.add_model("m", FakeEngine())
    server, base = start(pkg, reg)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/models/promote", {"model": "m", "ckpt": "/x"})
        assert exc.value.code == 503
    finally:
        stop(server)
        reg.close()


def test_http_tenant_over_quota_is_503_with_retry_after(pkg):
    reg = make_registry(pkg, admission=pkg.fleet.AdmissionController(max_tenant_rows=2))
    reg.add_model("m", FakeEngine())
    server, base = start(pkg, reg)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/embed", {"images": imgs(1, 2, 3).tolist(), "tenant": "greedy"})
        assert exc.value.code == 503 and exc.value.headers["Retry-After"] == "1"
        assert post(base, "/embed", {"images": imgs(1, 2).tolist(), "tenant": "fair"})[0] == 200
    finally:
        stop(server)
        reg.close()


def test_http_metrics_exposition(fleet):
    base, _, _ = fleet
    post(base, "/embed", {"images": imgs(1).tolist()})
    _, text = get_raw(base, "/metrics")
    assert "\nserve_batcher_queue_depth " in "\n" + text
    assert "serve_batcher_last_completion_age_s " in text
    assert "serve_fleet_models 2" in text
    assert 'serve_fleet_model_serving_version{model="prod"} 1' in text
    assert 'serve_fleet_index_entries{model="prod"} 1' in text
    assert 'serve_fleet_index_inserts_total{model="prod"} 1' in text
    assert 'serve_fleet_index_evictions_total{model="prod"} 0' in text
    assert 'serve_fleet_index_queries_total{model="prod"} 0' in text
    assert 'serve_fleet_index_probes_total{model="prod"} 0' in text
    assert 'serve_fleet_index_retrains_total{model="prod"} 0' in text


def test_http_metrics_ivf_probe_and_query_counters(fleet_ivf):
    base, _ = fleet_ivf
    post(base, "/embed", {"images": imgs(1, 2).tolist()})
    post(base, "/neighbors", {"images": imgs(1).tolist(), "k": 1})
    _, text = get_raw(base, "/metrics")
    assert 'serve_fleet_index_entries{model="prod"} 2' in text
    assert 'serve_fleet_index_queries_total{model="prod"} 1' in text
    assert 'serve_fleet_index_probes_total{model="prod"} 1' in text
    assert 'serve_fleet_index_retrains_total{model="prod"} 0' in text


def test_fleet_cli_retrieval_ladder_flags(pkg):
    args = pkg.frontend.build_parser().parse_args([])
    assert args.retrieval_impl == "auto"
    assert args.ivf_nlist == 0
    assert args.ivf_nprobe == 8
    assert args.neighbors_max_k == pkg.frontend.DEFAULT_NEIGHBORS_MAX_K == 100
    bad = pkg.frontend.build_parser().parse_args(
        ["--retrieval_impl", "ivf", "--index_capacity", "0"])
    with pytest.raises(ValueError, match="index_capacity"):
        pkg.frontend.build_fleet_stack(bad)


def test_the_two_frontends_answer_alike():
    """The same requests to both frontends: codes, reply keys, embeddings,
    neighbor ids and the /metrics series names."""
    answers = {}
    for name, pkg in PACKAGES.items():
        reg = make_registry(pkg, index_capacity=16,
                            admission=pkg.fleet.AdmissionController(max_tenant_rows=4))
        reg.add_model("prod", FakeEngine(scale=2.0))
        server, base = start(pkg, reg, promote_loader=lambda n, c: FakeEngine(3.0),
                             metrics_fn=pkg.frontend.fleet_metrics_fn(reg))
        got = []
        try:
            for path, body in (
                    ("/embed", {"images": imgs(1, 5, 9).tolist()}),
                    ("/embed", {"images": imgs(1, 2, 3, 4, 5).tolist(), "tenant": "t"}),
                    ("/neighbors", {"images": imgs(5).tolist(), "k": 2}),
                    ("/embed", {"images": imgs(1).tolist(), "model": "ghost"}),
                    ("/models/promote", {"model": "prod", "ckpt": "/c"}),
                    ("/embed", {"images": imgs(6).tolist()}),
                    ("/nope", {})):
                try:
                    status, reply = post(base, path, body)
                except urllib.error.HTTPError as e:
                    status, reply = e.code, json.loads(e.read())
                reply.pop("error", None)
                got.append((status, reply))
            reg.wait_drained("prod", 1, timeout=5)
            got.append(json.loads(get_raw(base, "/models")[1]))
            got.append(sorted({line.split("{")[0].split(" ")[0]
                               for line in get_raw(base, "/metrics")[1].splitlines()}))
        finally:
            stop(server)
            reg.close()
        answers[name] = got
    assert answers["jax"] == answers["port"]


# --------------------------------------------------------- the port, real engines


def test_shared_cache_misses_after_swap_to_identical_weights():
    from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache
    from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine

    shared = EmbeddingCache(capacity=256)
    e1, e2 = (EmbeddingEngine.random_init(model_name="resnet10", size=8, seed=0, buckets=(2,),
                                          cache=shared, device="cpu") for _ in range(2))
    assert e1._weights_probe == e2._weights_probe
    x = np.random.default_rng(0).integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    reg = make_registry(PACKAGES["port"])
    try:
        reg.add_model("m", e1)
        first = reg.submit(x)[1].result(30)
        assert e1.stats()["cache_hit_rows"] == 0
        np.testing.assert_array_equal(reg.submit(x)[1].result(30), first)
        assert e1.stats()["cache_hit_rows"] == 2
        reg.promote("m", e2)
        np.testing.assert_array_equal(reg.submit(x)[1].result(30), first)
        assert e2.stats()["cache_hit_rows"] == 0
        reg.submit(x)[1].result(30)
        assert e2.stats()["cache_hit_rows"] == 2
    finally:
        reg.close()


def test_cli_fleet_stack_on_cpu_promotes_a_checkpoint_of_another_width(tmp_path):
    """``build_fleet_stack`` on ``--device cpu`` (rn10 projections, 128
    wide); a promote loads a ``.pth`` whose head is 64 wide, and ``/embed``
    and ``/neighbors`` answer after it."""
    from simclr_pytorch_distributed_tpu_torch.models import SupConResNet

    torch.manual_seed(1)
    narrow = SupConResNet("resnet10", "mlp", 64)
    ckpt = tmp_path / "narrow.pth"
    torch.save({"opt": {"dataset": "cifar10", "size": 8},
                "model": {f"module.{k}": v for k, v in narrow.state_dict().items()}}, ckpt)
    args = port_frontend.build_parser().parse_args([
        "--device", "cpu", "--model", "resnet10", "--img_size", "8", "--buckets", "2",
        "--output", "projection", "--index_capacity", "32", "--port", "0",
        "--max_wait_ms", "1"])
    reg, server = port_frontend.build_fleet_stack(args)
    port_server.start_in_thread(server)
    base = "http://%s:%d" % server.server_address[:2]
    x = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    try:
        status, r = post(base, "/embed", {"images": x.tolist()}, timeout=60)
        assert status == 200 and r["dim"] == 128
        status, r = post(base, "/models/promote", {"model": "default", "ckpt": str(ckpt)},
                         timeout=60)
        assert status == 200 and r["version"] == 2
        status, r = post(base, "/embed", {"images": x.tolist()}, timeout=60)
        assert status == 200 and r["dim"] == 64
        status, r = post(base, "/neighbors", {"images": x[:1].tolist(), "k": 2}, timeout=60)
        assert status == 200
        assert r["neighbors"][0][0]["id"] == reg.content_id(x[0])
    finally:
        stop(server)
        reg.close()
