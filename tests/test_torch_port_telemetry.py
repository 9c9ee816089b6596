"""The port's metric ring and telemetry flush against the JAX package's, on
the CPU at a small size.

- ``MetricRing``: the same metric stream (seeded numpy values, unsorted
  keys, a start step that wraps the slots) written into the port's ring
  and the JAX ring gives the same columns and the same resolved rows
  (exact: both store fp32 and read back floats), and both raise alike on
  an overflow and on foreign keys; the port's tensor-valued block columns
  round-trip and read NaN where a step gave none;
- one ``device_get`` per window (the injected transfer is counted);
- ``FlushExecutor`` runs jobs FIFO; a failing job never raises at
  submission and surfaces at the next boundary as the JAX session's
  exception type (code 2 -> ``TelemetryFlushError``, 1 ->
  ``NonFiniteLossError``, 3 -> ``RepresentationHealthError``);
- the pretrain driver (rn10, 8 px, a 64-image set of 8 steps, print_freq
  3, health every 2nd step, the online probe) logs bitwise the same
  history under ``--telemetry async`` and ``sync``, and a TensorBoard
  write that fails exits 2 (not the NaN path: no crash save);
- at P = 2 over gloo (``tests/torch_parallel_child.py`` suite
  ``telemetry``) the failure codes meet in the boundary's one all-gather:
  every rank raises the same type, with health 3 > flush 2 > NaN 1; and the health
  and online-probe columns of two data-parallel steps (fused and ring
  loss, cross-replica BN) match one process's on the global batch
  (``HEALTH_RTOL``, ``GRAD_NORM_RTOL``; the probe's weights at
  ``PROBE_RTOL``);
- the boundary exchange's skew gauges: at P = 2 (suite ``skew``), with the
  last rank late by ``SKEW_PACE_S`` at every boundary, each boundary after
  the first publishes ``boundary_skew_seconds`` near the pace,
  ``boundary_straggler`` naming the late rank and ``process_count`` 2, and
  records a ``boundary_skew`` event naming it, from one all-gather a
  boundary and no other collective; one process publishes the JAX
  package's zeros with straggler -1.
"""

import glob
import logging
import math
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.ops.metrics import MetricRing as JaxMetricRing
from simclr_pytorch_distributed_tpu.utils import telemetry as jtelemetry
from simclr_pytorch_distributed_tpu_torch.ops.metrics import MetricRing
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import HEALTH_COV
from simclr_pytorch_distributed_tpu_torch.utils import guard
from simclr_pytorch_distributed_tpu_torch.utils.logging_utils import TBLogger
from simclr_pytorch_distributed_tpu_torch.utils.telemetry import (
    FlushExecutor,
    TelemetryFlushError,
    TelemetrySession,
)
from torch_threads import limit_threads

limit_threads()

# P = 2 against one process: the step pins of tests/test_torch_port_parallel.py
# for the loss-like columns; the gradient norm sums every parameter's
# gradient, whose cross-replica BN terms add in another order
HEALTH_RTOL, GRAD_NORM_RTOL, PROBE_RTOL = 2e-5, 1e-4, 1e-4


@pytest.mark.parametrize("window, n_keys, steps, flush, start, seed", [
    (3, 4, 7, 3, 0, 0), (5, 7, 12, 4, 3, 1), (4, 1, 9, 4, 6, 2), (8, 10, 8, 8, 13, 3),
])
def test_metric_ring_rows_match_jax(window, n_keys, steps, flush, start, seed):
    rng = np.random.default_rng(seed)
    keys = [f"m{i}" for i in rng.permutation(n_keys)]
    port, jring = MetricRing(window, keys), JaxMetricRing(window, keys)
    assert port.keys == jring.keys
    pbuf, jbuf = port.init_buffer(), jring.init_buffer()
    got, want = [], []
    for i, step in enumerate(range(start, start + steps)):
        values = rng.standard_normal(n_keys).astype(np.float32)
        port.write(pbuf, {k: torch.tensor(v) for k, v in zip(keys, values)}, step)
        jbuf = jring.write(jbuf, {k: jnp.asarray(v) for k, v in zip(keys, values)}, step)
        port.append(("info", step), step)
        jring.append(("info", step), step)
        if (i + 1) % flush == 0 or i + 1 == steps:
            assert port.pending_count() == jring.pending_count()
            got += port.resolve(port.snapshot(pbuf), port.take_window())
            want += jring.resolve(jnp.array(jbuf), jring.take_window())
    assert got == want and len(got) == steps
    assert port.transfers == jring.transfers


def test_ring_overflow_and_foreign_keys_raise_like_jax():
    for ring in (MetricRing(2, ("a",)), JaxMetricRing(2, ("a",))):
        ring.append(None, 0)
        ring.append(None, 1)
        with pytest.raises(RuntimeError, match="metric ring overflow: 2 steps pending"):
            ring.append(None, 2)
    port, jring = MetricRing(2, ("a", "b")), JaxMetricRing(2, ("a", "b"))
    with pytest.raises(ValueError, match="metric keys"):
        port.write(port.init_buffer(), {"a": torch.tensor(1.0)}, 0)
    with pytest.raises(ValueError, match="metric keys"):
        jring.write(jring.init_buffer(), {"a": jnp.asarray(1.0)}, 0)
    for bad in ((0, ("a",)), (2, ("a", "a"))):
        with pytest.raises(ValueError):
            MetricRing(*bad)


def test_block_columns_round_trip_and_read_nan_when_absent():
    ring = MetricRing(3, ("loss",), blocks={HEALTH_COV: (2, 2)})
    assert ring.width == 5
    buf = ring.init_buffer()
    cov = torch.arange(4.0).reshape(2, 2)
    ring.write(buf, {"loss": torch.tensor(1.5), HEALTH_COV: cov}, 4)
    ring.write(buf, {"loss": torch.tensor(2.5)}, 5)
    ring.append("a", 4)
    ring.append("b", 5)
    (_, first), (_, second) = ring.resolve(ring.snapshot(buf), ring.take_window())
    assert first["loss"] == 1.5 and np.array_equal(first[HEALTH_COV], cov.numpy())
    assert second["loss"] == 2.5 and np.isnan(second[HEALTH_COV]).all()
    with pytest.raises(ValueError, match="collide"):
        MetricRing(2, ("a",), blocks={"a": (1,)})


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_one_device_get_per_window(mode):
    calls = []

    def device_get(snapshot):
        calls.append(threading.current_thread().name)
        return snapshot.tensor.numpy()

    session = TelemetrySession(3, ("loss",), mode, device_get=device_get)
    buf = session.init_buffer()
    seen = []
    for step in range(7):
        session.ring.write(buf, {"loss": torch.tensor(float(step))}, step)
        session.append(step, step)
        if (step + 1) % 3 == 0 or step == 6:
            session.flush_boundary(buf, lambda rows: seen.extend(m["loss"] for _, m in rows),
                                   step_hint=step)
    session.drain()
    session.close()
    assert len(calls) == session.ring.transfers == 3
    assert seen == [float(s) for s in range(7)]
    want_thread = "telemetry-flush" if mode == "async" else threading.current_thread().name
    assert set(calls) == {want_thread}


def test_flush_executor_is_fifo():
    ex = FlushExecutor("async")
    out = []
    for i in range(40):
        ex.submit(lambda i=i: (time.sleep(0.001 * (i % 3)), out.append(i)))
    ex.drain()
    ex.close()
    assert out == list(range(40))
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(lambda: None)


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("failure, want", [
    (lambda: OSError("disk full"), "TelemetryFlushError"),
    (lambda: guard.NonFiniteLossError(float("nan"), 5), "NonFiniteLossError"),
    (lambda: guard.RepresentationHealthError(["collapse"], 5), "RepresentationHealthError"),
])
def test_failure_surfaces_at_the_boundary_as_jax_does(mode, failure, want):
    """A failing job: submission does not raise; the next boundary raises
    the type the JAX session raises for the same failure (the JAX session
    classifies through the JAX package's own guard types, so the JAX run
    is given those)."""
    from simclr_pytorch_distributed_tpu.utils import guard as jguard

    port = TelemetrySession(4, ("loss",), mode)
    jax_session = jtelemetry.TelemetrySession(4, ("loss",), mode)
    jax_failure = {"NonFiniteLossError": lambda: jguard.NonFiniteLossError(float("nan"), 5),
                   "RepresentationHealthError": lambda: jguard.RepresentationHealthError(
                       ["collapse"], 5)}.get(want, failure)
    names = []
    for session, make in ((port, failure), (jax_session, jax_failure)):
        def job(make=make):
            raise make()
        session.executor.submit(job)  # never raises here
        with pytest.raises(BaseException) as exc:
            session.drain_global(step_hint=5)
        names.append(type(exc.value).__name__)
        session.check_failures_global(6)  # the executor is clean again
        session.close()
    assert names == [want, want]


def tiny_dataset(dataset, data_folder):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    means = rng.uniform(48, 208, (10, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 32, (80, 8, 8, 3)), 0, 255).astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
    "--batch_size", "8", "--learning_rate", "0.05", "--temp", "0.5", "--print_freq", "3",
    "--feat_dim", "16", "--loss_impl", "fused", "--epochs", "1", "--health_freq", "2",
    "--online_probe", "on",
]


def pretrain(monkeypatch, workdir, *extra):
    monkeypatch.setattr(supcon, "load_dataset", tiny_dataset)
    root = logging.getLogger()
    before = set(root.handlers)
    try:
        return supcon.main(ARGV + ["--workdir", str(workdir), *extra])
    finally:  # each run's log-ing holds its own lines only
        for handler in set(root.handlers) - before:
            root.removeHandler(handler)
            handler.close()


def test_async_and_sync_log_the_same_history(monkeypatch, tmp_path):
    runs = {mode: pretrain(monkeypatch, tmp_path / mode, "--telemetry", mode)
            for mode in ("async", "sync")}
    a, s = runs["async"].history, runs["sync"].history
    assert len(a) == len(s) == 8
    for got, want in zip(a, s):
        assert got.keys() == want.keys()
        for key in got:
            if key != "step_time":
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # health steps carry values, the others the NaN sentinel
    assert [math.isfinite(h["health_align"]) for h in a] == [s % 2 == 0 for s in range(8)]
    assert all(math.isfinite(h["probe_loss"]) for h in a)
    for mode, run in runs.items():
        log = open(os.path.join(run.save_folder, "log-ing")).read()
        assert log.count("Train: [1]") == 3, mode  # boundaries 3, 6 and 8


def test_a_failing_tensorboard_write_exits_2(monkeypatch, tmp_path):
    def broken(self, tag, value, step):
        raise OSError("no space left on device")

    monkeypatch.setattr(TBLogger, "log_value", broken)
    with pytest.raises(SystemExit) as exc:
        pretrain(monkeypatch, tmp_path)
    assert exc.value.code == guard.EXIT_FLUSH == 2
    assert isinstance(exc.value.__cause__, TelemetryFlushError)
    assert isinstance(exc.value.__cause__.__cause__, OSError)
    assert not glob.glob(str(tmp_path / "*" / "*" / "crash_epoch_*.pth"))
    events = glob.glob(str(tmp_path / "*" / "*" / "events.jsonl"))[0]
    assert '"run_exit"' in open(events).read().splitlines()[-1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return child.spawn(2, tmp_path_factory.mktemp("telemetry2"), "telemetry")


@pytest.mark.parametrize("case, want", [
    ("clean", "none"), ("nan_on_one_rank", "NonFiniteLossError"),
    ("flush_beats_nan", "TelemetryFlushError"),
    ("health_beats_flush", "RepresentationHealthError"),
])
def test_failure_codes_meet_in_one_all_reduce(world2, case, want):
    """The codes meet in the boundary's one collective, now the all-gather
    of ``[code, wait]`` rows (span ``failure_code_allgather``): every
    process raises the highest code."""
    assert [r["failures"][case] for r in world2] == [want, want]


@pytest.mark.parametrize("case", child.HEALTH_CASES)
def test_health_and_probe_columns_at_two_processes_match_one(world2, case):
    single = child.health_step_case(case, 0, 1, False)
    for r in world2:
        for step, (got, want) in enumerate(zip(r["health"][case]["history"],
                                               single["history"])):
            assert got.keys() == want.keys()
            for key, value in want.items():
                if key == HEALTH_COV:
                    torch.testing.assert_close(got[key], value, rtol=HEALTH_RTOL, atol=1e-6)
                else:
                    rtol = GRAD_NORM_RTOL if key == "health_grad_norm" else HEALTH_RTOL
                    np.testing.assert_allclose(got[key], value, rtol=rtol, atol=1e-6,
                                               err_msg=f"{case} step {step} {key}")
        for key, value in single["probe"].items():
            torch.testing.assert_close(r["health"][case]["probe"][key], value,
                                       rtol=PROBE_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def skew2(tmp_path_factory):
    return child.spawn(2, tmp_path_factory.mktemp("skew2"), "skew")


def test_the_exchange_names_the_paced_process(skew2):
    late = 1  # the suite paces the last rank
    for rank, r in enumerate(skew2):
        first, *rest = r["gauges"]
        # the first boundary carries no previous wait: no skew yet
        assert "boundary_skew_seconds" not in first and first["collective_wait_seconds"] >= 0
        assert len(rest) == child.SKEW_BOUNDARIES - 1
        for g in rest:
            assert g["boundary_straggler"] == late and g["process_count"] == 2
            assert 0.5 * child.SKEW_PACE_S <= g["boundary_skew_seconds"] <= 2 * child.SKEW_PACE_S
        assert [e["args"]["straggler"] for e in r["events"]] == [late] * len(rest)
        assert [e["args"]["step"] for e in r["events"]] == list(range(1, child.SKEW_BOUNDARIES))
        assert {e["track"] for e in r["events"]} == {"fleet"}
    # the paced rank waits least: its own wait is far below its peer's
    waits = [r["gauges"][-1]["collective_wait_seconds"] for r in skew2]
    assert waits[late] < waits[0]


def test_the_exchange_is_one_all_gather_a_boundary(skew2):
    for r in skew2:
        assert r["calls"] == {"all_gather_into_tensor": child.SKEW_BOUNDARIES}


def test_one_process_publishes_zero_skew_and_no_straggler():
    from simclr_pytorch_distributed_tpu_torch.utils.prom import TrainerGauges

    gauges = TrainerGauges()
    session = TelemetrySession(4, ("loss",), "async", gauges=gauges)
    try:
        session.check_failures_global(step_hint=3)
    finally:
        session.close()
    got = gauges.collect()
    assert {k: got[k] for k in ("collective_wait_seconds", "boundary_skew_seconds",
                                "boundary_straggler", "process_count")} == {
        "collective_wait_seconds": 0.0, "boundary_skew_seconds": 0.0,
        "boundary_straggler": -1.0, "process_count": 1.0}
