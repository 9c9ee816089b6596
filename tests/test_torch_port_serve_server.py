"""The port's HTTP endpoint (``serve/server.py``) against the JAX package's:
the bodies of ``tests/test_serve_server.py`` run on both packages'
``create_server`` over their ``DynamicBatcher`` with a fake per-row embed
function (real sockets, server threads, no child process), so both answer
the same status codes, headers and JSON; one test sends the same requests
to both servers and compares the replies' codes and keys and the
``/metrics`` series names. The port's CLI stack (``build_stack``) runs on
``--device cpu``; without it the port asks for the card and raises here.
"""

import base64
import http.client
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.serve import batcher as jax_batcher
from simclr_pytorch_distributed_tpu.serve import server as jax_server
from simclr_pytorch_distributed_tpu.utils import prom as jax_prom
from simclr_pytorch_distributed_tpu.utils import tracing as jax_tracing
from simclr_pytorch_distributed_tpu_torch.serve import batcher as port_batcher
from simclr_pytorch_distributed_tpu_torch.serve import server as port_server
from simclr_pytorch_distributed_tpu_torch.utils import prom as port_prom
from simclr_pytorch_distributed_tpu_torch.utils import tracing as port_tracing
from torch_threads import limit_threads

limit_threads()

PACKAGES = {
    "jax": types.SimpleNamespace(batcher=jax_batcher, server=jax_server, prom=jax_prom,
                                 tracing=jax_tracing),
    "port": types.SimpleNamespace(batcher=port_batcher, server=port_server, prom=port_prom,
                                  tracing=port_tracing),
}

H = W = 2


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def fake_embed(images):
    images = np.asarray(images)
    return images.reshape(len(images), -1).sum(axis=1, keepdims=True).astype(np.float32)


def fake_bucket_for(n):
    for b in (1, 8, 32):
        if n <= b:
            return b
    return 32


class FakeEngine:
    bucket_for = staticmethod(fake_bucket_for)

    def stats(self):
        return {"requests": 2, "images": 7, "padded_rows": 3, "cache_hit_rows": 1,
                "bucket_dispatches": {8: 2}, "cache": {"hits": 1, "misses": 6}}


def post(base, path, obj, timeout=10):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(base, path, timeout=10):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def serve(pkg, batcher, stats_fn, **kwargs):
    server = pkg.server.create_server(batcher, stats_fn, port=0, **kwargs)
    pkg.server.start_in_thread(server)
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture()
def served(pkg):
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=2)
    server, base = serve(pkg, batcher, lambda: {"batcher": batcher.stats()})
    yield base, batcher
    stop(server)
    batcher.close()


def test_healthz_and_stats(served):
    base, _ = served
    assert get(base, "/healthz") == (200, {"status": "ok"})
    status, stats = get(base, "/stats")
    assert status == 200 and "batcher" in stats


def test_embed_nested_list_and_b64_agree(served):
    base, _ = served
    images = np.arange(2 * H * W * 3, dtype=np.uint8).reshape(2, H, W, 3)
    s1, r1 = post(base, "/embed", {"images": images.tolist()})
    s2, r2 = post(base, "/embed", {"images_b64": base64.b64encode(images.tobytes()).decode(),
                                   "shape": list(images.shape)})
    assert s1 == s2 == 200
    assert r1["n"] == 2 and r1["dim"] == 1
    np.testing.assert_array_equal(r1["embeddings"], r2["embeddings"])
    np.testing.assert_allclose(np.asarray(r1["embeddings"]), fake_embed(images))


BAD_BODIES = [
    {"images": [[1, 2], [3, 4]]},
    {"images": [[[["x"]]]]},
    {"images_b64": "AAAA", "shape": [1, H, W]},
    {"images_b64": "AAAA", "shape": [4, H, W, 3]},
    {"images_b64": "not base64!!", "shape": [1, 1, 1, 3]},
    {"wrong_key": 1},
    {"images": [[[[0, 0, 0]]]], "timeout_ms": "100"},
]


@pytest.mark.parametrize("body", BAD_BODIES)
def test_embed_bad_input_is_400(served, body):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        post(base, "/embed", body)
    assert exc.value.code == 400
    assert "error" in json.loads(exc.value.read())


def test_unknown_path_is_404(served):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        get(base, "/nope")
    assert exc.value.code == 404


def test_metrics_404_without_metrics_fn(served):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        get(base, "/metrics")
    assert exc.value.code == 404


def test_queue_full_maps_to_503_with_retry_after(pkg):
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_queue=1, start=False)
    server, base = serve(pkg, batcher, lambda: {})
    try:
        batcher.submit(np.zeros((1, H, W, 3), np.uint8))
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/embed", {"images": np.zeros((1, H, W, 3)).tolist()})
        assert exc.value.code == 503
        assert exc.value.headers["Retry-After"] == "1"
    finally:
        stop(server)
        batcher.close(drain=False)


def test_closed_batcher_maps_to_503_not_400(pkg):
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, start=False)
    batcher.close()
    server, base = serve(pkg, batcher, lambda: {})
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/embed", {"images": np.zeros((1, H, W, 3), np.uint8).tolist()})
        assert exc.value.code == 503
    finally:
        stop(server)


def test_oversized_content_length_replies_400_and_closes_connection(pkg):
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=2)
    server, _ = serve(pkg, batcher, lambda: {})
    host, port = server.server_address[:2]
    try:
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.putrequest("POST", "/embed")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(10**9))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert resp.getheader("Connection") == "close"
        resp.read()
        conn.close()
    finally:
        stop(server)
        batcher.close()


def test_request_timeout_maps_to_504(pkg):
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, start=False)
    server, base = serve(pkg, batcher, lambda: {})
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(base, "/embed", {"images": np.zeros((1, H, W, 3), np.uint8).tolist(),
                                  "timeout_ms": 30})
        assert exc.value.code == 504
    finally:
        stop(server)
        batcher.close(drain=False)


def test_stats_latency_quantiles_and_metrics_exposition(pkg):
    latency = pkg.prom.LatencyHistogram()
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=2,
                                         latency=latency, bucket_fn=fake_bucket_for)
    server, base = serve(
        pkg, batcher, pkg.server.combined_stats_fn(FakeEngine(), batcher, latency),
        metrics_fn=pkg.server.serve_metrics_fn(FakeEngine(), batcher, latency))
    try:
        images = np.zeros((3, H, W, 3), np.uint8)
        for _ in range(4):
            batcher.submit(images).result(timeout=10)
        status, stats = get(base, "/stats")
        assert status == 200
        lat = stats["latency"]["8"]
        assert lat["count"] == 4
        assert 0 <= lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"]
        assert "pipeline_occupancy" in stats["batcher"]
        assert "avg_inflight_depth" in stats["batcher"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            body = r.read().decode()
        assert 'serve_request_latency_ms_bucket{bucket="8",le="+Inf"} 4' in body
        assert 'serve_request_latency_ms_count{bucket="8"} 4' in body
        assert "serve_batcher_pipeline_occupancy" in body
        assert "serve_engine_requests_total 2" in body
        assert 'serve_engine_bucket_dispatches_total{bucket="8"} 2' in body
        assert "serve_cache_hits 1" in body
    finally:
        stop(server)
        batcher.close()


def test_serve_watchdog_arms_only_while_inflight(pkg, tmp_path):
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    wd = pkg.tracing.StallWatchdog(10.0, str(tmp_path), clock=clk, start=False, name="serve")
    batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=0,
                                         start=False, watchdog=wd, clock=clk)
    clk.t += 1000.0
    assert not wd.check()
    batcher.submit(np.zeros((2, H, W, 3), np.uint8))
    batcher._dispatch(batcher._next_batch())
    wd.arm()
    clk.t += 11.0
    assert wd.check()
    wd.disarm()
    clk.t += 1000.0
    assert not wd.check()
    batcher.close()


def test_latency_histogram_quantiles_and_samples(pkg):
    hist = pkg.prom.LatencyHistogram()
    for ms in (0.5, 3.0, 3.0, 40.0, 120000.0):
        hist.observe(8, ms)
    hist.observe("1", 7.0)
    summary = hist.summary()
    assert summary["8"]["count"] == 5 and summary["1"]["count"] == 1
    assert summary["8"]["p99_ms"] == hist.bounds[-1]  # overflow clamps to the top bound
    assert hist.quantile(8, 0.5) == summary["8"]["p50_ms"]
    samples = hist.samples("lat")
    assert samples[-1] == ("lat_count", {"bucket": "8"}, 5)
    with pytest.raises(ValueError):
        pkg.prom.LatencyHistogram((5.0, 1.0))


def test_the_two_histograms_agree():
    """The same observations give the same summary and exposition."""
    hists = [PACKAGES[name].prom.LatencyHistogram() for name in sorted(PACKAGES)]
    rng = np.random.default_rng(0)
    for key, ms in zip(rng.integers(0, 3, 200), rng.lognormal(2.0, 2.0, 200)):
        for hist in hists:
            hist.observe(int(key), float(ms))
    assert hists[0].summary() == hists[1].summary()
    assert hists[0].samples("x") == hists[1].samples("x")
    assert (jax_prom.render_prometheus(hists[0].samples("x"))
            == port_prom.render_prometheus(hists[1].samples("x")))


def test_the_two_servers_answer_alike():
    """The same requests to both packages' servers: the same status codes,
    reply keys, embeddings and /metrics series."""
    answers = {}
    for name, pkg in PACKAGES.items():
        latency = pkg.prom.LatencyHistogram()
        batcher = pkg.batcher.DynamicBatcher(fake_embed, max_batch=8, max_wait_ms=0,
                                             latency=latency, bucket_fn=fake_bucket_for)
        server, base = serve(
            pkg, batcher, pkg.server.combined_stats_fn(FakeEngine(), batcher, latency),
            metrics_fn=pkg.server.serve_metrics_fn(FakeEngine(), batcher, latency))
        got = []
        try:
            images = np.arange(3 * H * W * 3, dtype=np.uint8).reshape(3, H, W, 3)
            for body in [{"images": images.tolist()}] + BAD_BODIES:
                try:
                    status, reply = post(base, "/embed", body)
                except urllib.error.HTTPError as e:
                    status, reply = e.code, json.loads(e.read())
                got.append((status, sorted(reply), reply.get("embeddings")))
            status, stats = get(base, "/stats")
            got.append((status, sorted(stats), sorted(stats["batcher"])))
            with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
                names = sorted({line.split("{")[0].split(" ")[0]
                                for line in r.read().decode().splitlines()})
            got.append(names)
        finally:
            stop(server)
            batcher.close()
        answers[name] = got
    assert answers["jax"] == answers["port"]


# ------------------------------------------------------------ the port's CLI


def test_build_stack_cli_plumbing_bf16_and_pipeline_knobs():
    """``--dtype bf16``, ``--max_inflight`` and ``--device cpu`` reach the
    engine and the batcher through the parser, and one request flows
    through the pipelined stack."""
    args = port_server.build_parser().parse_args([
        "--model", "resnet10", "--buckets", "2", "--img_size", "8", "--dtype", "bf16",
        "--max_inflight", "3", "--max_inflight_images", "64", "--max_wait_ms", "1",
        "--port", "0", "--device", "cpu",
    ])
    engine, batcher, server = port_server.build_stack(args)
    try:
        assert engine.dtype == "bf16" and engine.device.type == "cpu"
        s = batcher.stats()
        assert s["max_inflight"] == 3 and s["max_inflight_images"] == 64
        port_server.start_in_thread(server)
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        status, reply = post(base, "/embed", {"images": np.zeros((1, 8, 8, 3), np.uint8)
                                              .tolist()}, timeout=120)
        assert status == 200 and reply["dim"] == 512 and reply["n"] == 1
        assert np.isfinite(np.asarray(reply["embeddings"])).all()
        status, stats = get(base, "/stats")
        assert stats["engine"]["dtype"] == "bf16"
        assert stats["batcher"]["dispatched_batches"] >= 1
        assert "inflight_batches" in stats["batcher"]
    finally:
        stop(server)
        batcher.close()


def test_the_cli_defaults_to_the_card():
    args = port_server.build_parser().parse_args(["--model", "resnet10", "--img_size", "8"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default stack would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.build_stack(args)
