"""The port's flight recorder, stall watchdog, Prometheus sidecar and
profiler window against the JAX package's, on the CPU.

- ``FlightRecorder`` fed the same calls on the same fake clock as the JAX
  recorder writes the same ``events.jsonl`` lines and the same Chrome
  trace; ``chrome_trace_from_events`` and ``run_paths`` equal the JAX
  functions on the same inputs;
- ``render_prometheus`` and ``TrainerGauges`` render
  the same text as the JAX package's on the same samples and clocks;
- the stall watchdog fires once on a stall (a fake clock), dumps every
  thread's stack and a recorder snapshot, and a beat re-arms it;
- the sidecar serves ``/metrics`` and ``/healthz`` on port 0 (loopback);
- ``StepTracer`` writes a Chrome trace of its window and nothing outside;
- ``RunObservability`` closes with the run's exit code on the record.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from simclr_pytorch_distributed_tpu.utils import prom as jprom
from simclr_pytorch_distributed_tpu.utils import tracing as jtracing
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.utils import prom, tracing
from simclr_pytorch_distributed_tpu_torch.utils.obs import RunObservability
from simclr_pytorch_distributed_tpu_torch.utils.profiling import StepClock, StepTracer
from torch_threads import limit_threads

limit_threads()


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def record(rec, clock):
    """One fixed sequence of recorder calls."""
    with rec.span("epoch", track="main:epoch", epoch=1):
        clock.advance(0.25)
        rec.event("preempt_exit", track="main:guard", epoch=1, step_in_epoch=3)
        rec.clock_anchor("flush_boundary", step=7)
        clock.advance(1.5)
    rec.record_span("flush_job", "telemetry:flush", clock() - 0.125, clock(), steps=4)
    rec.event("bare")


@pytest.mark.parametrize("max_events", [65536, 3])
def test_recorder_writes_what_jax_writes(tmp_path, max_events):
    out = {}
    for name, mod in (("port", tracing), ("jax", jtracing)):
        clock = FakeClock()
        rec = mod.FlightRecorder(str(tmp_path / f"{name}.jsonl"), clock=clock,
                                 max_events=max_events,
                                 trace_path=str(tmp_path / f"{name}.json"), process_index=2)
        record(rec, clock)
        rec.close()
        rec.event("after_close")  # dropped silently
        out[name] = (open(tmp_path / f"{name}.jsonl").read(),
                     json.load(open(tmp_path / f"{name}.json")), rec.dropped)
    assert out["port"] == out["jax"]
    assert out["port"][2] == (3 if max_events == 3 else 0)


def test_chrome_trace_matches_jax():
    events = [
        {"name": "a", "track": "main:flush", "ph": "X", "ts": 0.5, "dur": 0.25,
         "args": {"step": 3}},
        {"name": "b", "track": "health", "ph": "i", "ts": 1.0},
        {"name": "c", "ph": "X", "ts": 1.1234567, "dur": 1e-7},
        {"name": "d", "track": "main:flush", "ph": "i", "ts": 2.0, "args": {"x": [1, 2]}},
    ]
    for pidx in (0, 3):
        assert (tracing.chrome_trace_from_events(events, process_index=pidx)
                == jtracing.chrome_trace_from_events(events, process_index=pidx))


def test_session_files_match_jax(tmp_path):
    for pidx in (0, 1):
        for _ in range(3):  # three sessions of each process
            got = tracing.run_paths(str(tmp_path), pidx)
            assert got == jtracing.run_paths(str(tmp_path), pidx)
            open(got[0], "w").close()
    assert sorted(os.listdir(tmp_path)) == [
        "events.jsonl", "events_p1.jsonl", "events_p1_r2.jsonl", "events_p1_r3.jsonl",
        "events_r2.jsonl", "events_r3.jsonl"]


def test_recorder_for_run_without_a_process_group(tmp_path):
    rec = tracing.recorder_for_run(str(tmp_path))
    assert rec.process_index == 0 == tracing.process_index()
    rec.event("start")
    rec.close()
    assert sorted(os.listdir(tmp_path)) == ["events.jsonl", "trace.json"]
    assert tracing.recorder_for_run(str(tmp_path), enabled=False) is None


def test_module_level_helpers_are_no_ops_without_a_recorder(tmp_path):
    tracing.uninstall()
    with tracing.span("x", track="main:x"):
        tracing.event("y")
    assert tracing.clock_anchor("z") is None
    rec = tracing.FlightRecorder(str(tmp_path / "e.jsonl"))
    tracing.install(rec)
    try:
        with tracing.span("x", track="main:x"):
            tracing.event("y")
        assert tracing.clock_anchor("z") == 1
    finally:
        tracing.uninstall()
    assert [r["name"] for r in rec.snapshot()] == ["y", "x", "clock_anchor"]


SAMPLES = [
    ("train_step", None, 12345678),
    ("train_loss", None, 0.1 + 0.2),
    ("latency_ms", {"bucket": "64", "le": "+Inf"}, 7),
    ("odd", {"path": 'a"b\\c\nd'}, 2.5e-9),
    ("big", None, 2 ** 60),
    ("neg", {"z": 1, "a": 2}, -3.0),
]


def test_prometheus_text_matches_jax():
    assert prom.render_prometheus(SAMPLES) == jprom.render_prometheus(SAMPLES)
    assert prom.render_prometheus([]) == jprom.render_prometheus([]) == "\n"


def test_trainer_gauges_match_jax():
    texts = []
    for mod in (prom, jprom):
        clock = FakeClock(50.0)
        gauges = mod.TrainerGauges(clock=clock, wall_clock=lambda: 1700000000.0)
        before = gauges.prometheus_text()
        gauges.beat(41)
        clock.advance(2.5)
        gauges.set(epoch=3, inflight_windows=1, health_align=0.25)
        gauges.register("dropped", lambda: 4)
        gauges.register("broken", lambda: 1 / 0)
        gauges.set_exit_code(75)
        texts.append((before, gauges.prometheus_text()))
    assert texts[0] == texts[1]
    assert "train_last_boundary_age_seconds 2.5" in texts[0][1]


def test_watchdog_fires_once_on_a_stall_and_rearms(tmp_path):
    clock = FakeClock()
    rec = tracing.FlightRecorder(clock=clock)
    rec.event("before_the_stall")
    dog = tracing.StallWatchdog(5.0, str(tmp_path), clock=clock, recorder=rec, start=False)
    clock.advance(4.0)
    assert not dog.check()
    clock.advance(2.0)
    assert dog.check() and not dog.check()  # one dump a stall
    stacks = open(tmp_path / "stall_dump_1.txt").read()
    assert "STALL: train progress beat stalled for 6.0s" in stacks
    assert "test_watchdog_fires_once_on_a_stall_and_rearms" in stacks  # this thread's frame
    dump = json.load(open(tmp_path / "stall_dump_1.json"))
    assert dump["dump"] == 1 and [e["name"] for e in dump["events"]][0] == "before_the_stall"
    assert rec.snapshot()[-1]["name"] == "stall_detected"
    dog.beat()
    clock.advance(5.5)
    assert dog.check() and os.path.isfile(tmp_path / "stall_dump_2.txt")
    dog.disarm()
    clock.advance(60.0)
    assert not dog.check()
    with pytest.raises(ValueError):
        tracing.StallWatchdog(0, str(tmp_path), start=False)


def test_watchdog_thread_dumps_a_real_stall(tmp_path):
    dog = tracing.StallWatchdog(0.05, str(tmp_path), poll_s=0.01)
    try:
        for _ in range(500):
            if dog.dumps:
                break
            time.sleep(0.01)
    finally:
        dog.close()
    assert dog.dumps >= 1 and os.path.isfile(tmp_path / "stall_dump_1.txt")


def get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def test_sidecar_serves_metrics_on_port_0():
    gauges = prom.TrainerGauges()
    gauges.beat(17)
    server = prom.start_metrics_server(0, gauges.prometheus_text)
    try:
        host, port = server.server_address[:2]
        assert host == "127.0.0.1" and port > 0
        status, ctype, body = get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "train_step 17\n" in body and "train_start_time_seconds" in body
        assert get(f"http://127.0.0.1:{port}/healthz")[2] == '{"status": "ok"}'
        with pytest.raises(urllib.error.HTTPError) as err:
            get(f"http://127.0.0.1:{port}/nope")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_step_tracer_writes_a_trace_of_its_window_only(tmp_path):
    tracer = StepTracer(str(tmp_path), start_step=2, num_steps=2)
    x = torch.randn(64, 64)
    for step in range(6):
        x = torch.tanh(x @ x.T / 64)
        tracer.step(step)
        if step < 2:
            assert tracer.profile is None
        elif step < 5:  # opened at step 2 for steps 3 and 4
            assert tracer.profile is not None
    assert tracer.path == str(tmp_path / "trace_steps_3_5.json")
    trace = json.load(open(tracer.path))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"aten::mm", "aten::tanh"} <= names
    assert os.listdir(tmp_path) == ["trace_steps_3_5.json"]
    tracer.close()  # one window a run: closing again writes nothing
    assert not StepTracer("", 0, 2).enabled and not StepTracer(str(tmp_path), 0, 0).enabled


def test_step_clock_on_the_cpu():
    clock = StepClock(torch.device("cpu"))
    for _ in range(4):
        clock.mark()
    seconds = clock.seconds()
    assert len(seconds) == 3 and all(s >= 0 for s in seconds)
    assert clock.seconds() == []


def test_run_observability_records_the_exit_and_serves_gauges(tmp_path):
    cfg = config_lib.SupConConfig(save_folder=str(tmp_path), watchdog_secs=30.0)
    obs = RunObservability(cfg, "supcon")
    assert obs.recorder is tracing.current() and obs.health is not None
    assert obs.watchdog is not None and obs.gauges is None
    obs.set_epoch(2)
    obs.close(exit_code=3)
    assert tracing.current() is None
    last = json.loads(open(tmp_path / "events.jsonl").read().splitlines()[-1])
    assert (last["name"], last["args"]) == ("run_exit", {"code": 3})
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]
    off = config_lib.SupConConfig(save_folder=str(tmp_path / "off"), flight_recorder="off",
                                  health_freq=0)
    obs = RunObservability(off, "supcon")
    assert obs.recorder is None and obs.health is None
    obs.close(exit_code=0)
    assert not os.path.exists(tmp_path / "off")
