"""The port's ``serve/batcher.py`` and ``serve/cache.py`` against the JAX
package's: the same test bodies run on both packages' classes
(parametrised), with fake per-row engines, so the observable results are
the same ones: coalescing, ``QueueFull`` backpressure, timeouts on a fake
clock, draining, the ``max_inflight`` window and its FIFO completion,
stats keys, and the cache's LRU, counters and frozen rows.

The bodies are those of ``tests/test_serve_batcher.py``,
``tests/test_serve_pipeline.py`` (its gated-dispatch tests; the real-engine
stress runs on the port engine here) and ``tests/test_serve_cache.py``.
"""

import threading
import time
import types

import numpy as np
import pytest

from simclr_pytorch_distributed_tpu.serve import batcher as jax_batcher
from simclr_pytorch_distributed_tpu.serve import cache as jax_cache
from simclr_pytorch_distributed_tpu_torch.serve import batcher as port_batcher
from simclr_pytorch_distributed_tpu_torch.serve import cache as port_cache
from torch_threads import limit_threads

limit_threads()

PACKAGES = {
    "jax": types.SimpleNamespace(batcher=jax_batcher, cache=jax_cache),
    "port": types.SimpleNamespace(batcher=port_batcher, cache=port_cache),
}

H = W = 2


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def fake_embed(images):
    """Per-row map: embedding = [sum of the image's pixels]."""
    images = np.asarray(images)
    return images.reshape(len(images), -1).sum(axis=1, keepdims=True).astype(np.float32)


def imgs(*values):
    out = np.zeros((len(values), H, W, 3), np.uint8)
    for i, v in enumerate(values):
        out[i] = v
    return out


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return False


# ------------------------------------------------------------ policy (no thread)


def test_coalesces_pending_requests_into_one_batch(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=50, start=False)
    futs = [b.submit(imgs(1, 2)), b.submit(imgs(3)), b.submit(imgs(4, 5, 6))]
    batch = b._next_batch()
    assert [r.n for r in batch] == [2, 1, 3]
    b._dispatch(batch)
    np.testing.assert_array_equal(futs[0].result(0), fake_embed(imgs(1, 2)))
    np.testing.assert_array_equal(futs[1].result(0), fake_embed(imgs(3)))
    np.testing.assert_array_equal(futs[2].result(0), fake_embed(imgs(4, 5, 6)))
    s = b.stats()
    assert s["batches"] == 1 and s["batched_images"] == 6


def test_max_batch_splits_but_never_splits_a_request(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=50, start=False)
    for _ in range(3):
        b.submit(imgs(*range(3)))
    assert [r.n for r in b._next_batch()] == [3, 3]
    assert [r.n for r in b._next_batch()] == [3]


def test_oversize_request_dispatches_alone(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=4, max_wait_ms=50, start=False)
    fut = b.submit(imgs(*range(10)))
    b.submit(imgs(1))
    batch = b._next_batch()
    assert [r.n for r in batch] == [10]
    b._dispatch(batch)
    assert fut.result(0).shape == (10, 1)


def test_backpressure_rejects_with_queue_full(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_queue=3, start=False)
    for _ in range(3):
        b.submit(imgs(1))
    with pytest.raises(pkg.batcher.QueueFull):
        b.submit(imgs(2))
    assert b.stats()["rejected"] == 1
    assert b.stats()["queue_depth"] == 3


def test_backpressure_bounds_queued_rows_not_just_requests(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_queue=100,
                                   max_queue_images=10, start=False)
    b.submit(imgs(*range(6)))
    with pytest.raises(pkg.batcher.QueueFull, match="row cap"):
        b.submit(imgs(*range(5)))
    b.submit(imgs(*range(4)))
    assert b.stats()["queued_images"] == 10
    b._dispatch(b._next_batch())
    assert b.stats()["queued_images"] == 4
    b.submit(imgs(*range(6)))


def test_validate_hook_rejects_at_submit(pkg):
    def gate(images):
        if images.shape[1] != H:
            raise ValueError("wrong geometry")
        return images

    b = pkg.batcher.DynamicBatcher(fake_embed, validate=gate, start=False)
    b.submit(imgs(1))
    with pytest.raises(ValueError, match="wrong geometry"):
        b.submit(np.zeros((1, H + 1, W, 3), np.uint8))
    assert b.stats()["submitted"] == 1


def test_expired_request_fails_with_timeout_on_fake_clock(pkg):
    clock = FakeClock()
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=0, clock=clock,
                                   start=False)
    stale = b.submit(imgs(1), timeout_ms=1000)
    live = b.submit(imgs(2))
    clock.advance(2.0)
    batch = b._next_batch()
    assert [r.n for r in batch] == [1] and batch[0].future is live
    with pytest.raises(pkg.batcher.RequestTimeout):
        stale.result(0)
    assert b.stats()["timeouts"] == 1


def test_expired_request_mid_queue_does_not_drop_its_neighbor(pkg):
    clock = FakeClock()
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=0, clock=clock,
                                   start=False)
    a = b.submit(imgs(1))
    stale = b.submit(imgs(2), timeout_ms=500)
    c = b.submit(imgs(3))
    clock.advance(1.0)
    batch = b._next_batch()
    assert [r.future for r in batch] == [a, c]
    b._dispatch(batch)
    np.testing.assert_array_equal(a.result(0), fake_embed(imgs(1)))
    np.testing.assert_array_equal(c.result(0), fake_embed(imgs(3)))
    with pytest.raises(pkg.batcher.RequestTimeout):
        stale.result(0)


def test_mixed_shapes_split_into_separate_batches(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=0, start=False)
    small = b.submit(imgs(1))
    big = b.submit(np.full((1, 4, 4, 3), 7, np.uint8))
    first = b._next_batch()
    assert [r.future for r in first] == [small]
    second = b._next_batch()
    assert [r.future for r in second] == [big]
    b._dispatch(first)
    b._dispatch(second)
    np.testing.assert_array_equal(small.result(0), fake_embed(imgs(1)))
    np.testing.assert_array_equal(big.result(0),
                                  fake_embed(np.full((1, 4, 4, 3), 7, np.uint8)))


# ------------------------------------------------------- worker thread (live)


def test_live_roundtrip_and_close_drains(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=5)
    futs = [b.submit(imgs(i)) for i in range(6)]
    b.close()
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(fut.result(0), fake_embed(imgs(i)))
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(imgs(0))
    s = b.stats()
    assert s["batched_images"] == 6 and s["batches"] <= 6


def test_close_without_drain_fails_pending(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, start=False)
    fut = b.submit(imgs(1))
    b.close(drain=False)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(0)


def test_close_with_no_worker_fails_pending_even_when_draining(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, start=False)
    fut = b.submit(imgs(1))
    b.close(drain=True)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(0)


def test_fake_clock_controls_the_coalescing_window(pkg):
    clock = FakeClock()
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=10_000, clock=clock,
                                   poll_interval=0.001)
    try:
        fut = b.submit(imgs(3))
        time.sleep(0.03)
        assert not fut.done()
        clock.advance(11.0)
        np.testing.assert_array_equal(fut.result(timeout=2), fake_embed(imgs(3)))
    finally:
        b.close()


def test_engine_error_propagates_to_every_waiter(pkg):
    def broken(images):
        raise ValueError("engine exploded")

    b = pkg.batcher.DynamicBatcher(broken, max_batch=8, max_wait_ms=5)
    try:
        futs = [b.submit(imgs(1)), b.submit(imgs(2))]
        for fut in futs:
            with pytest.raises(ValueError, match="engine exploded"):
                fut.result(timeout=2)
        assert b.stats()["errors"] >= 1
    finally:
        b.close()


def test_concurrent_submitters_all_get_their_rows(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=16, max_wait_ms=5)
    results = {}
    lock = threading.Lock()

    def client(i):
        out = b.submit(imgs(i, i)).result(timeout=5)
        with lock:
            results[i] = out

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    b.close()
    for i in range(8):
        np.testing.assert_array_equal(results[i], fake_embed(imgs(i, i)))


def test_pipeline_stats_present_in_no_worker_path(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, start=False)
    s = b.stats()
    assert s["inflight_batches"] == 0 and s["inflight_rows"] == 0
    assert s["dispatched_batches"] == 0 and s["max_inflight_observed"] == 0
    b.submit(imgs(1))
    b._dispatch(b._next_batch())
    s = b.stats()
    assert s["dispatched_batches"] == 1 and s["batches"] == 1
    assert s["max_inflight"] == 2
    b.close()


def test_submit_validation(pkg):
    b = pkg.batcher.DynamicBatcher(fake_embed, start=False)
    with pytest.raises(ValueError):
        b.submit(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        b.submit(np.zeros((0, 4, 4, 3), np.uint8))


def test_the_two_batchers_report_the_same_stats():
    """One scenario on both packages: the same keys and the same counts."""
    stats = {}
    for name, pkg in PACKAGES.items():
        clock = FakeClock()
        b = pkg.batcher.DynamicBatcher(fake_embed, max_batch=4, max_queue=3, max_wait_ms=0,
                                       clock=clock, start=False)
        b.submit(imgs(1, 2))
        b.submit(imgs(3), timeout_ms=10)
        b.submit(imgs(4, 5, 6))
        with pytest.raises(pkg.batcher.QueueFull):
            b.submit(imgs(7))
        clock.advance(1.0)
        b._dispatch(b._next_batch())
        b._dispatch(b._next_batch())
        stats[name] = b.stats()
        b.close()
    assert stats["jax"] == stats["port"]


# ------------------------------------------------- the pipeline (gated fakes)


class GatedDispatch:
    """Fake async engine: dispatch returns at once, each handle's
    ``result()`` blocks until the test opens that handle's gate."""

    def __init__(self):
        self.handles = []
        self.lock = threading.Lock()
        self.auto = False

    def __call__(self, images):
        h = _GatedHandle(np.asarray(images))
        with self.lock:
            if self.auto:
                h.gate.set()
            self.handles.append(h)
        return h

    def release_all(self):
        with self.lock:
            self.auto = True
            for h in self.handles:
                h.gate.set()

    def count(self):
        with self.lock:
            return len(self.handles)


class _GatedHandle:
    def __init__(self, images):
        self.images = images
        self.gate = threading.Event()

    def result(self):
        assert self.gate.wait(10), "test forgot to release a gate"
        return fake_embed(self.images)


def make(pkg, dispatch, **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait_ms", 0)
    return pkg.batcher.DynamicBatcher(dispatch_fn=dispatch, **kw)


def test_next_batch_dispatched_before_previous_materializes(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2)
    try:
        f1 = b.submit(imgs(1))
        f2 = b.submit(imgs(2))
        assert wait_until(lambda: d.count() == 2)
        assert not f1.done() and not f2.done()
        s = b.stats()
        assert s["inflight_batches"] == 2 and s["inflight_rows"] == 2
        assert s["dispatched_batches"] == 2 and s["batches"] == 0
        d.release_all()
        np.testing.assert_array_equal(f1.result(5), fake_embed(imgs(1)))
        np.testing.assert_array_equal(f2.result(5), fake_embed(imgs(2)))
    finally:
        d.release_all()
        b.close()
    assert b.stats()["max_inflight_observed"] == 2


def test_inflight_batch_count_bound_enforced(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2)
    try:
        futs = [b.submit(imgs(i)) for i in range(4)]
        assert wait_until(lambda: d.count() == 2)
        time.sleep(0.05)
        assert d.count() == 2
        d.handles[0].gate.set()
        assert wait_until(lambda: d.count() == 3)
        time.sleep(0.05)
        assert d.count() == 3
        d.release_all()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(5), fake_embed(imgs(i)))
    finally:
        d.release_all()
        b.close()


def test_inflight_row_bound_enforced_under_load(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=8, max_inflight_images=5)
    try:
        futs = [b.submit(imgs(i, i)) for i in range(4)]
        assert wait_until(lambda: d.count() == 2)
        time.sleep(0.05)
        assert d.count() == 2 and b.stats()["inflight_rows"] == 4
        d.handles[0].gate.set()
        assert wait_until(lambda: d.count() == 3)
        d.release_all()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(5), fake_embed(imgs(i, i)))
    finally:
        d.release_all()
        b.close()


def test_oversized_batch_admitted_alone_not_deadlocked(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2, max_inflight_images=3)
    try:
        f = b.submit(imgs(1, 2, 3, 4, 5))
        assert wait_until(lambda: d.count() == 1)
        d.release_all()
        np.testing.assert_array_equal(f.result(5), fake_embed(imgs(1, 2, 3, 4, 5)))
    finally:
        d.release_all()
        b.close()


def test_completion_is_fifo_in_dispatch_order(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2)
    try:
        f1 = b.submit(imgs(1))
        f2 = b.submit(imgs(2))
        assert wait_until(lambda: d.count() == 2)
        d.handles[1].gate.set()
        time.sleep(0.05)
        assert not f2.done()
        d.handles[0].gate.set()
        np.testing.assert_array_equal(f1.result(5), fake_embed(imgs(1)))
        np.testing.assert_array_equal(f2.result(5), fake_embed(imgs(2)))
    finally:
        d.release_all()
        b.close()


def test_close_drains_inflight_batches_cleanly(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2)
    futs = [b.submit(imgs(i)) for i in range(3)]
    assert wait_until(lambda: d.count() == 2)
    releaser = threading.Timer(0.05, d.release_all)
    releaser.start()

    def late_release():
        wait_until(lambda: d.count() == 3)
        d.release_all()

    t = threading.Thread(target=late_release)
    t.start()
    b.close()
    releaser.join()
    t.join(10)
    assert not t.is_alive()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), fake_embed(imgs(i)))


def test_close_without_drain_still_completes_dispatched_batches(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=1)
    in_flight = b.submit(imgs(1))
    assert wait_until(lambda: d.count() == 1)
    held = b.submit(imgs(2))
    queued = b.submit(imgs(3))
    assert wait_until(lambda: b.stats()["queue_depth"] == 1)
    assert d.count() == 1
    threading.Timer(0.05, d.release_all).start()
    b.close(drain=False)
    np.testing.assert_array_equal(in_flight.result(5), fake_embed(imgs(1)))
    np.testing.assert_array_equal(held.result(5), fake_embed(imgs(2)))
    with pytest.raises(RuntimeError, match="closed"):
        queued.result(0)


def test_dispatch_error_fails_batch_immediately(pkg):
    def broken(images):
        raise ValueError("dispatch exploded")

    b = pkg.batcher.DynamicBatcher(dispatch_fn=broken, max_batch=8, max_wait_ms=0)
    try:
        fut = b.submit(imgs(1))
        with pytest.raises(ValueError, match="dispatch exploded"):
            fut.result(5)
        assert b.stats()["errors"] >= 1
    finally:
        b.close()


def test_completion_error_fails_waiters_and_frees_the_window(pkg):
    class BrokenHandle:
        def result(self):
            raise RuntimeError("D2H exploded")

    b = make(pkg, lambda images: BrokenHandle(), max_inflight=1)
    try:
        f1 = b.submit(imgs(1))
        f2 = b.submit(imgs(2))
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="D2H exploded"):
                f.result(5)
        s = b.stats()
        assert s["errors"] == 2 and s["inflight_batches"] == 0
    finally:
        b.close()


def test_constructor_validation(pkg):
    DynamicBatcher = pkg.batcher.DynamicBatcher
    with pytest.raises(ValueError, match="embed_fn or dispatch_fn"):
        DynamicBatcher()
    with pytest.raises(ValueError, match="not both"):
        DynamicBatcher(fake_embed, dispatch_fn=GatedDispatch())
    with pytest.raises(ValueError, match="max_inflight"):
        DynamicBatcher(fake_embed, max_inflight=0)
    with pytest.raises(ValueError, match="max_inflight"):
        DynamicBatcher(fake_embed, max_inflight_images=0)


def test_occupancy_gauges_present_and_bounded(pkg):
    d = GatedDispatch()
    b = make(pkg, d, max_inflight=2)
    try:
        f = b.submit(imgs(1))
        assert wait_until(lambda: d.count() == 1)
        time.sleep(0.03)
        s = b.stats()
        assert s["inflight_batches"] == 1
        assert 0.0 < s["pipeline_occupancy"] <= 1.0
        assert 0.0 < s["avg_inflight_depth"] <= 2.0
        d.release_all()
        f.result(5)
    finally:
        d.release_all()
        b.close()
    s = b.stats()
    assert s["max_inflight"] == 2 and s["max_inflight_images"] == 4096


# -------------------------------------------- the port engine behind the batcher


def test_concurrent_mixed_sizes_match_sequential_embed():
    """Threads x mixed request sizes through the pipelined batcher on the
    port engine equal its sequential ``embed`` within the cross-bucket pin
    (coalescing may route a request through another bucket)."""
    from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine

    engine = EmbeddingEngine.random_init(model_name="resnet10", size=8, buckets=(2, 8),
                                         device="cpu")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (int(n), 8, 8, 3), dtype=np.uint8)
                for n in rng.integers(1, 9, size=12)]
    expected = [engine.embed(x) for x in requests]
    b = port_batcher.DynamicBatcher(dispatch_fn=engine.dispatch, max_batch=8, max_wait_ms=2,
                                    max_inflight=3, max_inflight_images=64,
                                    validate=engine.validate_images)
    results, errors = [None] * len(requests), []

    def client(k):
        try:
            results[k] = b.submit(requests[k]).result(timeout=60)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((k, e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    b.close()
    assert not errors, errors
    for k, (got, want) in enumerate(zip(results, expected)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"request {k}")
    assert b.stats()["errors"] == 0


# ------------------------------------------------------------------ the cache


def row(v, dim=4):
    return np.full((dim,), v, np.float32)


def test_put_get_and_counters(pkg):
    c = pkg.cache.EmbeddingCache(capacity=8)
    assert c.get(b"a") is None
    c.put(b"a", row(1.0))
    np.testing.assert_array_equal(c.get(b"a"), row(1.0))
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 1 and s["entries"] == 1
    assert s["hit_rate"] == 0.5


def test_lru_eviction_order_respects_access(pkg):
    c = pkg.cache.EmbeddingCache(capacity=2)
    c.put(b"a", row(1))
    c.put(b"b", row(2))
    assert c.get(b"a") is not None
    c.put(b"c", row(3))
    assert c.get(b"b") is None
    assert c.get(b"a") is not None and c.get(b"c") is not None
    assert c.stats()["evictions"] == 1
    assert len(c) == 2


def test_stored_rows_are_frozen(pkg):
    c = pkg.cache.EmbeddingCache(capacity=4)
    src = row(1.0)
    c.put(b"k", src)
    src[:] = 99.0
    got = c.get(b"k")
    np.testing.assert_array_equal(got, row(1.0))
    with pytest.raises(ValueError):
        got[0] = 5.0


def test_overwrite_same_key_keeps_size(pkg):
    c = pkg.cache.EmbeddingCache(capacity=4)
    c.put(b"k", row(1))
    c.put(b"k", row(2))
    assert len(c) == 1
    np.testing.assert_array_equal(c.get(b"k"), row(2))


def test_put_many_matches_put_semantics(pkg):
    c = pkg.cache.EmbeddingCache(capacity=3)
    src = row(1.0)
    c.put_many([(b"a", src), (b"b", row(2)), (b"c", row(3)), (b"d", row(4))])
    src[:] = 99.0
    assert len(c) == 3
    assert c.get(b"a") is None
    assert c.stats()["evictions"] == 1
    np.testing.assert_array_equal(c.get(b"b"), row(2))
    with pytest.raises(ValueError):
        c.get(b"d")[0] = 5.0
    c.put_many([])
    assert len(c) == 3


def test_clear_and_capacity_validation(pkg):
    c = pkg.cache.EmbeddingCache(capacity=4)
    c.put(b"k", row(1))
    c.clear()
    assert len(c) == 0 and c.get(b"k") is None
    with pytest.raises(ValueError):
        pkg.cache.EmbeddingCache(capacity=0)
