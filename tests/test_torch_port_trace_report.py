"""The port's recorder readers (``utils/tracing.py``) and its trace report
(``utils/trace_report.py``, CLI ``scripts/port_trace_report.py``) against
the JAX package's, on the CPU.

A run folder is written by the port's ``FlightRecorder`` as a two-process
run would write it (``run_paths``: ``events.jsonl`` and ``events_p1.jsonl``,
then a resumed session's ``_r2`` files), process 1 on a drifted, offset
clock and late at every boundary exchange by ``LATE`` seconds, its last
session ending in the torn line a SIGKILL leaves. Then:

- ``parse_jsonl``, ``load_events_jsonl``, ``session_files_for`` and
  ``discover_fleet_sessions`` equal the JAX package's on those files;
- each session's fleet report (``build_fleet_report``), merged Chrome trace
  and rendered table equal JAX ``scripts/trace_report.py``'s on the same
  events, and name process 1 as the straggler at every boundary;
- the CLI's ``--fleet`` and ``--events`` artifacts equal the JAX script's.
"""

import importlib.util
import json
import os

import pytest
from torch_threads import limit_threads

from simclr_pytorch_distributed_tpu.utils import tracing as jax_tracing
from simclr_pytorch_distributed_tpu_torch.utils import trace_report, tracing

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATE, SCALE, OFFSET = 0.4, 1.02, 5.0


def jax_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "scripts", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_session(run_dir, boundaries, start):
    """One recorder session of two processes on the port's recorder."""
    clocks = {0: [start], 1: [SCALE * start + OFFSET]}
    recorders = {}
    for p in (0, 1):
        events, trace = tracing.run_paths(run_dir, p)
        recorders[p] = tracing.FlightRecorder(
            events, clock=lambda p=p: clocks[p][0], trace_path=trace, process_index=p)

    def at(t):
        clocks[0][0], clocks[1][0] = t, SCALE * t + OFFSET

    at(start + 1.0)
    for p, rec in recorders.items():
        rec.record_span("first_step", "main:compile", rec.now(), rec.now() + SCALE ** p)
    for k in range(boundaries):
        t = start + 10.0 + 5.0 * k
        arrive = {0: t - LATE - 0.05, 1: t - 0.05}
        for p, rec in recorders.items():
            a = SCALE * arrive[p] + OFFSET if p else arrive[p]
            end = SCALE * t + OFFSET if p else t
            rec.record_span("failure_code_allgather", "main:collective", a, end,
                            step=2 * (k + 1), local_code=0)
        at(t)
        for rec in recorders.values():
            rec.clock_anchor("flush_boundary", step=2 * (k + 1))
            rec.event("boundary_skew", track=tracing.FLEET_TRACK, step=2 * (k + 1),
                      skew_s=LATE, straggler=1)
    for rec in recorders.values():
        rec.close()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleet_run"))
    write_session(d, 3, 100.0)
    write_session(d, 2, 200.0)  # the resumed session
    with open(os.path.join(d, "events_p1_r2.jsonl"), "a") as f:
        f.write('{"name": "flush_boundary", "track": "main:fl')  # torn by a SIGKILL
    with open(os.path.join(d, "notes.jsonl"), "w") as f:
        f.write("{}\n")  # not a recorder file
    return d


def test_the_readers_equal_jax(run_dir):
    files = sorted(f for f in os.listdir(run_dir) if f.endswith(".jsonl"))
    assert files == ["events.jsonl", "events_p1.jsonl", "events_p1_r2.jsonl",
                     "events_r2.jsonl", "notes.jsonl"]
    for name in files:
        path = os.path.join(run_dir, name)
        text = open(path).read()
        assert tracing.parse_jsonl(text) == jax_tracing.parse_jsonl(text), name
        assert tracing.load_events_jsonl(path) == jax_tracing.load_events_jsonl(path)
        assert tracing.session_files_for(path) == jax_tracing.session_files_for(path)
    torn = open(os.path.join(run_dir, "events_p1_r2.jsonl")).read()
    records, consumed = tracing.parse_jsonl(torn)
    assert consumed == torn.rfind("\n") + 1 and records[-1]["name"] != "flush_boundary"
    assert tracing.session_files_for(os.path.join(run_dir, "events_p1.jsonl")) == [
        os.path.join(run_dir, "events_p1.jsonl"), os.path.join(run_dir, "events_p1_r2.jsonl")]
    sessions = tracing.discover_fleet_sessions(run_dir)
    assert sessions == jax_tracing.discover_fleet_sessions(run_dir)
    assert {k: sorted(v) for k, v in sessions.items()} == {"r1": [0, 1], "r2": [0, 1]}
    assert tracing.EVENTS_FILE_RE.pattern == jax_tracing.EVENTS_FILE_RE.pattern


def test_the_fleet_report_equals_jax(run_dir):
    jax_tr = jax_report()
    for label, files in tracing.discover_fleet_sessions(run_dir).items():
        events = {p: tracing.load_events_jsonl(path) for p, path in files.items()}
        got = trace_report.build_fleet_report(events)
        assert got == jax_tr.build_fleet_report(events), label
        assert got["consistency"]["ok"], got["consistency"]
        assert [r["straggler"] for r in got["skew_table"]] == [1] * len(got["skew_table"])
        assert all(abs(r["skew_s"] - LATE) < 1e-3 for r in got["skew_table"])
        assert trace_report.fleet_chrome_trace(events, got) == jax_tr.fleet_chrome_trace(
            events, got)
        assert trace_report.render_fleet_table(got) == jax_tr.render_fleet_table(got)
        for p, evs in events.items():
            assert trace_report.build_report(evs) == jax_tr.build_report(evs), (label, p)
    with pytest.raises(ValueError):
        trace_report.build_fleet_report({})
    with pytest.raises(ValueError):
        trace_report.build_report([])


def test_the_cli_artifacts_equal_jax(run_dir, tmp_path):
    jax_tr = jax_report()
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    trace = tmp_path / "merged.json"
    assert trace_report.main(["--fleet", run_dir, "--json", str(got),
                              "--trace", str(trace)]) == 0
    assert jax_tr.main(["--fleet", run_dir, "--json", str(want)]) == 0
    assert json.load(open(got)) == json.load(open(want))
    assert {e["pid"] for e in json.load(open(trace))["traceEvents"]} == {0, 1}
    events = os.path.join(run_dir, "events.jsonl")
    assert trace_report.main(["--events", events, "--json", str(got)]) == 0
    assert jax_tr.main(["--events", events, "--json", str(want)]) == 0
    assert json.load(open(got)) == json.load(open(want))
