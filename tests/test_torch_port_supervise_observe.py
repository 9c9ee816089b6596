"""The port's supervisor channels (``supervise/observe.py``) against the JAX
package's, on the CPU.

- ``parse_prometheus_text`` reads the port's sidecar text (``utils/prom``'s
  ``TrainerGauges``, with the boundary-skew gauges a one-process and a
  two-process exchange publish) as the JAX parser reads it, and a live
  sidecar on 127.0.0.1 scrapes to the same values; a dead one gives None;
- ``straggler_finding`` and ``StragglerTracker`` give the JAX package's
  findings and verdicts on the same gauge streams (K-of-N, the step dedup,
  dilution, an identity that hops, the one-process and missing-identity
  cases, reset, the disabled bar);
- ``RunDirWatcher`` on a port run folder: a torn ``.pth`` is not a
  checkpoint until it loads, a torn last ``events.jsonl`` line is read once
  it is whole, a fresh stall dump is reported once, a rewritten
  ``last.pth`` is new again, and rotated ``events_r2.jsonl`` is watched.
"""

import json
import os
import socket

import pytest
import torch
from torch_threads import limit_threads

from simclr_pytorch_distributed_tpu.supervise import observe as jax_observe
from simclr_pytorch_distributed_tpu_torch.supervise import observe
from simclr_pytorch_distributed_tpu_torch.utils import prom

limit_threads()


def sidecar_text(processes):
    """The port sidecar's text after a boundary of a ``processes`` fleet."""
    g = prom.TrainerGauges(wall_clock=lambda: 1234.5)
    g.beat(12)
    g.set(epoch=2, inflight_windows=1, collective_wait_seconds=0.0421)
    if processes == 1:
        g.set(boundary_skew_seconds=0.0, boundary_straggler=-1.0, process_count=1.0)
    else:
        g.set(boundary_skew_seconds=0.151, boundary_straggler=1.0,
              process_count=float(processes))
    g.set_exit_code(75)
    return g.prometheus_text()


@pytest.mark.parametrize("processes", [1, 2])
def test_the_parser_reads_the_ports_sidecar_as_jax_does(processes):
    text = sidecar_text(processes) + "# HELP noise\nbad line x\nlabeled{a=\"b\"} 3\n"
    got = observe.parse_prometheus_text(text)
    assert got == jax_observe.parse_prometheus_text(text)
    assert got["train_step"] == 12.0 and got["train_exit_code"] == 75.0
    assert got["train_start_time_seconds"] == 1234.5
    assert got[observe.PROC_COUNT_GAUGE] == processes
    assert got[observe.STRAGGLER_GAUGE] == (-1.0 if processes == 1 else 1.0)
    assert "labeled" not in got


def test_a_live_sidecar_scrapes_and_a_dead_one_gives_none():
    g = prom.TrainerGauges()
    g.beat(7)
    g.set(boundary_skew_seconds=0.2, boundary_straggler=1.0, process_count=2.0)
    server = prom.start_metrics_server(0, g.prometheus_text, host="127.0.0.1")
    try:
        scraped = observe.MetricsScraper(server.server_address[1]).scrape()
    finally:
        server.shutdown()
    assert scraped["train_step"] == 7.0 and scraped[observe.SKEW_GAUGE] == 0.2
    assert scraped["train_last_boundary_age_seconds"] >= 0.0
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert observe.MetricsScraper(port, timeout_s=0.2).scrape() is None


def skew(step, value=0.2, straggler=1, processes=2, wait=None):
    g = {"train_step": float(step), observe.SKEW_GAUGE: float(value),
         observe.PROC_COUNT_GAUGE: float(processes)}
    if straggler is not None:
        g[observe.STRAGGLER_GAUGE] = float(straggler)
    if wait is not None:
        g[observe.WAIT_GAUGE] = wait
    return g


def no_step(g):
    return {k: v for k, v in g.items() if k != "train_step"}


# name -> (bar, persist_k, window_n, the scrapes); None is a failed scrape
STREAMS = {
    "k_of_n_then_consume": (0.1, 3, 5, [skew(s) for s in (1, 2, 3, 4, 5, 6, 7)]),
    "dedup_on_the_step": (0.1, 3, 5, [skew(7)] * 6 + [no_step(skew(0))] * 2 + [skew(8)]),
    "below_bar_dilutes": (0.1, 3, 3, [skew(1), skew(2), skew(3, 0.0), skew(4, 0.0),
                                      skew(5)]),
    "identity_hops": (0.1, 3, 5, [skew(s, straggler=s % 3, processes=3)
                                  for s in range(1, 13)]),
    "one_process_is_benign": (0.1, 1, 1, [None, {}, skew(1, straggler=-1, processes=1),
                                          skew(2, straggler=None), skew(3, straggler=0,
                                                                        processes=1)]),
    "disabled_bar": (0.0, 1, 1, [skew(1), skew(2)]),
    "wait_and_step_context": (0.05, 1, 2, [skew(1, 0.151, wait=0.0421),
                                           skew(2, 0.01, wait=0.2)]),
}


def track(module, bar, k, n, scrapes, reset_at=None):
    t = module.StragglerTracker(bar, persist_k=k, window_n=n, clock=lambda: 42.0)
    out = []
    for i, g in enumerate(scrapes):
        if i == reset_at:
            t.reset()
        out.append((module.straggler_finding(g, bar), t.observe(g), t.take_persistent()))
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_findings_and_verdicts_equal_jax(name):
    bar, k, n, scrapes = STREAMS[name]
    got = track(observe, bar, k, n, scrapes)
    assert got == track(jax_observe, bar, k, n, scrapes)
    if name == "k_of_n_then_consume":
        verdicts = [v for _, _, v in got if v is not None]
        assert verdicts and verdicts[0]["straggler"] == 1 and verdicts[0]["votes"] == 3
        assert verdicts[0]["share"] == 0.5 and verdicts[0]["at"] == 42.0


def test_reset_clears_stale_votes_as_jax_does():
    scrapes = [skew(1), skew(2), skew(2), skew(3), skew(4)]
    got = track(observe, 0.1, 3, 5, scrapes, reset_at=2)
    assert got == track(jax_observe, 0.1, 3, 5, scrapes, reset_at=2)
    assert got[2][1] is not None  # the same step again: the dedup was cleared


@pytest.mark.parametrize("k, n", [(0, 5), (3, 2)])
def test_tracker_rejects_bad_arguments_alike(k, n):
    with pytest.raises(ValueError) as want:
        jax_observe.StragglerTracker(1.0, persist_k=k, window_n=n)
    with pytest.raises(ValueError) as got:
        observe.StragglerTracker(1.0, persist_k=k, window_n=n)
    assert str(got.value) == str(want.value)


def full_state(epoch):
    return {"model": {"w": torch.zeros(2)}, "epoch": epoch, "step": 4 * epoch,
            "step_in_epoch": 0}


def test_the_watcher_reads_a_port_run_folder(tmp_path):
    run_dir = tmp_path / "synthetic_models" / "run"
    w = observe.RunDirWatcher(str(run_dir))
    assert w.poll() == ([], [], [])  # not there yet: not an error
    run_dir.mkdir(parents=True)
    torch.save(full_state(1), run_dir / "ckpt_epoch_1.pth")
    (run_dir / "last.pth").write_bytes(b"PK\x03\x04 torn")  # a torn write
    (run_dir / "last.pth.tmp").write_bytes(b"partial")  # never a candidate
    (run_dir / "stall_dump_1.txt").write_text("stacks")
    events = run_dir / "events.jsonl"
    with open(events, "w") as f:
        f.write(json.dumps({"name": "health_alarm", "args": {"step": 5}}) + "\n")
        f.write(json.dumps({"name": "flush_boundary", "ph": "X"}) + "\n")  # not watched
        f.write('{"name": "preempt_ex')  # the torn last line a SIGKILL leaves

    dumps, evs, ckpts = w.poll()
    assert [os.path.basename(d) for d in dumps] == ["stall_dump_1.txt"]
    assert [(e["name"], e["_file"]) for e in evs] == [("health_alarm", "events.jsonl")]
    assert ckpts == ["ckpt_epoch_1.pth"]
    assert w.poll() == ([], [], [])  # nothing new

    with open(events, "a") as f:
        f.write('it", "args": {"epoch": 1}}\n')
    torch.save(full_state(2), run_dir / "last.pth")  # now whole
    _, evs, ckpts = w.poll()
    assert [e["name"] for e in evs] == ["preempt_exit"] and ckpts == ["last.pth"]

    st = os.stat(run_dir / "last.pth")
    torch.save(full_state(3), run_dir / "last.pth")  # the next epoch's rewrite
    os.utime(run_dir / "last.pth", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    (run_dir / "events_r2.jsonl").write_text(json.dumps({"name": "stall_detected"}) + "\n")
    st = os.stat(run_dir / "stall_dump_1.txt")
    os.utime(run_dir / "stall_dump_1.txt", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    dumps, evs, ckpts = w.poll()
    assert [os.path.basename(d) for d in dumps] == ["stall_dump_1.txt"]  # overwritten: new
    assert [(e["name"], e["_file"]) for e in evs] == [("stall_detected", "events_r2.jsonl")]
    assert ckpts == ["last.pth"]


def test_watched_events_are_the_jax_set():
    assert observe.WATCHED_EVENTS == jax_observe.WATCHED_EVENTS
    assert (observe.SKEW_GAUGE, observe.WAIT_GAUGE, observe.STRAGGLER_GAUGE,
            observe.PROC_COUNT_GAUGE) == (jax_observe.SKEW_GAUGE, jax_observe.WAIT_GAUGE,
                                          jax_observe.STRAGGLER_GAUGE,
                                          jax_observe.PROC_COUNT_GAUGE)
