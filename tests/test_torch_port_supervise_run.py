"""The port's supervisor loop (``supervise/supervisor.py``, the CLI) on the
CPU, against scripted children and the port's real trainer.

Scripted children (a few lines of Python each, no torch) drive the loop:
a preemption then a completion (``--resume`` appended on the relaunch, the
events recorded), the restart budget (the shell-normalized code), a
command that cannot start (127), a stall (a fresh watchdog dump, SIGTERM
absorbed, SIGKILL after the grace window), the straggler ladder off a
scripted scraper (the share hint and the process count in each relaunch's
environment), warn-only verdicts, a relayed SIGTERM, a resize request left
at the end (discarded), and the CLI's exit code.

Real processes run the port's trainer (``scripts/port_supervisor_victim.py``,
rn10 at 8 px on 64 synthetic images: 4 steps an epoch at batch 16):
a non-finite loss gives ``backoff_restart`` then ``done``; a collapse gives
``give_up`` and exit 3; a ``kill -9`` in epoch 2 resumes to a ``last.pth``
bitwise that of a straight run; a ``resize_request`` 2 -> 1 relaunches a
two-process gloo ``torchrun`` child (``parallel/torchrun.py``) at one
process, which completes; and the straggler scenario on
``scripts/port_fleet_launcher.py`` gives ``restart_rebalanced`` with
``FLEET_SHARE_HINT`` in the relaunch's environment and model digests equal
to those of a run with no supervisor and no straggler.
"""

import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch
from torch_threads import limit_threads

from simclr_pytorch_distributed_tpu_torch.supervise import launch, observe, policy
from simclr_pytorch_distributed_tpu_torch.supervise.__main__ import main as cli_main
from simclr_pytorch_distributed_tpu_torch.supervise.supervisor import (
    SuperviseConfig,
    Supervisor,
)

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VICTIM = os.path.join(REPO, "scripts", "port_supervisor_victim.py")
FLEET = os.path.join(REPO, "scripts", "port_fleet_launcher.py")
RUN = "synthetic_0101_0000_run"


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.delenv(launch.NPROC_ENV, raising=False)
    monkeypatch.delenv(launch.FLEET_SHARE_ENV, raising=False)


def read_events(sup):
    with open(os.path.join(sup.supervise_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def actions(sup):
    return [d.action for d in sup.decisions]


def run_in_thread(sup):
    box = {}
    t = threading.Thread(target=lambda: box.update(rc=sup.run()), daemon=True)
    t.start()

    def join(timeout=240):
        t.join(timeout)
        assert not t.is_alive(), "the supervisor did not finish"
        return box["rc"]

    return join


def wait_for(check, what, timeout=120):
    deadline = time.monotonic() + timeout
    while not check():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


# ------------------------------------------------ the loop, scripted children


@pytest.fixture(scope="module")
def saved_pth(tmp_path_factory):
    """A complete full-state checkpoint the scripted children copy in."""
    path = tmp_path_factory.mktemp("pth") / "full.pth"
    torch.save({"model": {"w": torch.zeros(2)}, "epoch": 1, "step": 4,
                "step_in_epoch": 0}, path)
    return str(path)


def scripted(tmp_path, saved_pth, body, checkpoint=True):
    """A child that logs its argv and environment, makes the run folder with
    a complete checkpoint in it (as a real save leaves one), then runs
    ``body`` (its invocation number is ``n``)."""
    log, ws = tmp_path / "calls.log", tmp_path / "ws"
    script = tmp_path / "child.py"
    script.write_text(f"""
import json, os, shutil, signal, sys, time
log = {str(log)!r}
with open(log, "a") as f:
    f.write(json.dumps({{"argv": sys.argv[1:],
                        "share": os.environ.get({launch.FLEET_SHARE_ENV!r}, ""),
                        "nproc": os.environ.get({launch.NPROC_ENV!r}, "")}}) + "\\n")
n = sum(1 for _ in open(log))
run_dir = os.path.join({str(ws)!r}, "synthetic_models", {RUN!r})
os.makedirs(run_dir, exist_ok=True)
if {checkpoint!r}:
    shutil.copy({saved_pth!r}, os.path.join(run_dir, "ckpt_epoch_1.pth"))
{body}
""")
    return [sys.executable, str(script)], log, ws


def calls(log):
    return [json.loads(line) for line in open(log)]


def test_preempt_then_done_appends_resume_and_records(tmp_path, saved_pth):
    cmd, log, ws = scripted(tmp_path, saved_pth, "sys.exit([75, 0][n - 1])")
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.02,
                                     backoff_base_s=0.01))
    assert sup.run() == 0
    assert actions(sup) == [policy.RESTART, policy.DONE]
    argv = [c["argv"] for c in calls(log)]
    assert "--resume" not in argv[0]
    assert argv[1][-2:] == ["--resume", str(ws / "synthetic_models" / RUN)]
    events = read_events(sup)
    names = [e["name"] for e in events]
    assert names.count("launch") == 2 and names.count("decision") == 2
    # each child writes the checkpoint anew: each write is observed
    assert ["ckpt_epoch_1.pth"] * 2 == [e["args"]["ckpt"] for e in events
                                        if e["name"] == "checkpoint_observed"]
    decision = [e["args"] for e in events if e["name"] == "decision"][0]
    assert set(decision) == {"action", "reason", "rc", "stalled", "delay_s", "devices",
                             "share", "restarts"}


def test_no_resume_without_a_complete_checkpoint(tmp_path, saved_pth):
    cmd, log, ws = scripted(tmp_path, saved_pth, "sys.exit([1, 0][n - 1])", checkpoint=False)
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.02,
                                     backoff_base_s=0.01))
    assert sup.run() == 0
    assert actions(sup) == [policy.BACKOFF_RESTART, policy.DONE]
    assert all("--resume" not in c["argv"] for c in calls(log))  # a fresh start


@pytest.mark.parametrize("codes, budget, want_rc, want", [
    ([1, 1], 1, 1, [policy.BACKOFF_RESTART, policy.GIVE_UP]),
    ([3], 5, 3, [policy.GIVE_UP]),
    ([-9, 0], 3, 0, [policy.BACKOFF_RESTART, policy.DONE]),
], ids=["budget", "health", "signal_death"])
def test_exit_codes_decide_the_run(tmp_path, saved_pth, codes, budget, want_rc, want):
    body = (f"code = {codes!r}[n - 1]\n"
            "if code < 0:\n    os.kill(os.getpid(), -code)\n"
            "sys.exit(code)")
    cmd, log, ws = scripted(tmp_path, saved_pth, body)
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), max_restarts=budget,
                                     poll_s=0.02, backoff_base_s=0.01))
    assert sup.run() == want_rc
    assert actions(sup) == want
    assert len(calls(log)) == len(codes)


def test_a_command_that_cannot_start_gives_up_with_127(tmp_path):
    sup = Supervisor(SuperviseConfig(command=[str(tmp_path / "no_such_trainer")],
                                     workdir=str(tmp_path / "ws"), poll_s=0.02))
    assert sup.run() == 127
    assert actions(sup) == [policy.GIVE_UP]
    assert [e["name"] for e in read_events(sup)].count("launch_failed") == 1


def test_a_stall_is_killed_through_the_grace_window(tmp_path, saved_pth):
    body = """
if n == 1:
    signal.signal(signal.SIGTERM, lambda *a: None)  # wedged: SIGTERM absorbed
    with open(os.path.join(run_dir, "stall_dump_1.txt"), "w") as f:
        f.write("stacks")
    time.sleep(60)
sys.exit(0)
"""
    cmd, log, ws = scripted(tmp_path, saved_pth, body)
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.05,
                                     stall_secs=30.0, grace_secs=0.5, backoff_base_s=0.01))
    start = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - start < 30
    assert actions(sup) == [policy.BACKOFF_RESTART, policy.DONE]
    assert sup.decisions[0].reason.startswith("stalled")
    events = read_events(sup)
    assert [e["args"]["rc"] for e in events if e["name"] == "child_run"] == [-9, 0]
    assert [e["args"]["fresh"] for e in events if e["name"] == "stall_dump_observed"] == [True]
    assert sum(e["name"] == "liveness_stall" for e in events) == 1


def alive(pid):
    """Whether ``pid`` runs: a zombie (exited, not yet reaped) does not."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_a_stall_under_the_torchrun_launcher_leaves_no_worker(tmp_path, saved_pth):
    """The port's launchers make the child ``parallel/torchrun.py``, whose
    workers run in sessions of their own: the kill after the grace window
    must take the wedged worker too, not only the launcher."""
    pids = tmp_path / "pids"
    body = f"""
with open({str(pids)!r}, "a") as f:
    f.write(f"{{os.getpid()}}\\n")
if n == 1:
    signal.signal(signal.SIGTERM, lambda *a: None)  # wedged: SIGTERM absorbed
    with open(os.path.join(run_dir, "stall_dump_1.txt"), "w") as f:
        f.write("stacks")
    time.sleep(60)
sys.exit(0)
"""
    cmd, log, ws = scripted(tmp_path, saved_pth, body)
    command = [sys.executable, "-m", "simclr_pytorch_distributed_tpu_torch.parallel.torchrun",
               "--standalone", "--nproc_per_node", "1"] + cmd[1:]
    sup = Supervisor(SuperviseConfig(command=command, workdir=str(ws), poll_s=0.05,
                                     stall_secs=30.0, grace_secs=0.5, backoff_base_s=0.01))
    start = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - start < 45
    assert actions(sup) == [policy.BACKOFF_RESTART, policy.DONE]
    codes = [e["args"]["rc"] for e in read_events(sup) if e["name"] == "child_run"]
    assert codes == [-9, 0]
    wedged, relaunched = [int(p) for p in pids.read_text().split()]
    assert wedged != relaunched and not alive(wedged)


class SkewScraper:
    """Boundary-skew gauges naming process 1 of 2, a new boundary each
    scrape, served only once the newest child is ready (has logged, after
    installing its SIGTERM handler)."""

    def __init__(self, log):
        self.log, self.step, self.sup = log, 0, None

    def scrape(self):
        ready = sum(1 for _ in open(self.log)) if os.path.exists(self.log) else 0
        if self.sup is None or ready <= len(self.sup.decisions):
            return None
        self.step += 1
        return {"train_step": float(self.step), observe.SKEW_GAUGE: 0.2,
                observe.STRAGGLER_GAUGE: 1.0, observe.PROC_COUNT_GAUGE: 2.0,
                "train_last_boundary_age_seconds": 0.1}


def test_the_straggler_ladder_carries_share_and_process_count(tmp_path, saved_pth):
    log, ws = tmp_path / "calls.log", tmp_path / "ws"
    script = tmp_path / "fleet_stub.py"
    # the child logs only after installing its handler: the scraper waits for it
    script.write_text(f"""
import json, os, shutil, signal, sys, time
signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
run_dir = os.path.join({str(ws)!r}, "synthetic_models", {RUN!r})
os.makedirs(run_dir, exist_ok=True)
shutil.copy({saved_pth!r}, os.path.join(run_dir, "preempt_epoch_1_step_2.pth"))
with open({str(log)!r}, "a") as f:
    f.write(json.dumps({{"argv": sys.argv[1:],
                        "share": os.environ.get({launch.FLEET_SHARE_ENV!r}, ""),
                        "nproc": os.environ.get({launch.NPROC_ENV!r}, "")}}) + "\\n")
time.sleep(60)
""")
    cmd = [sys.executable, str(script)]
    scraper = SkewScraper(str(log))
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), max_restarts=10,
                                     poll_s=0.05, grace_secs=20.0, devices=2,
                                     straggler_skew_secs=0.1, straggler_persist_k=3,
                                     straggler_window_n=5, straggler_mitigate=True),
                     scraper=scraper)
    scraper.sup = sup
    assert run_in_thread(sup)() == 75  # give_up reports the clean preempt's code
    assert actions(sup) == [policy.RESTART_REBALANCED, policy.RESTART_RESIZED, policy.GIVE_UP]
    assert sup.decisions[0].share == "1:0.5" and sup.decisions[1].devices == 1
    # the hint reached only the rebalanced relaunch; the exclusion rung ran
    # one process through torchrun's variable
    assert [(c["share"], c["nproc"]) for c in calls(log)] == [("", "2"), ("1:0.5", "2"),
                                                             ("", "1")]
    events = read_events(sup)
    assert [e["name"] for e in events].count("straggler_persistent") == 3
    assert [e["args"]["phase"] for e in events if e["name"] == "straggler_mitigation"] == [
        "preempt", "decided"] * 3


def test_warn_only_records_verdicts_and_keeps_the_child(tmp_path, saved_pth):
    cmd, log, ws = scripted(tmp_path, saved_pth, "time.sleep(1.0)\nsys.exit(0)")

    class Skew:
        step = 0

        def scrape(self):
            Skew.step += 1
            return {"train_step": float(Skew.step), observe.SKEW_GAUGE: 0.2,
                    observe.STRAGGLER_GAUGE: 1.0, observe.PROC_COUNT_GAUGE: 2.0}

    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.02,
                                     straggler_skew_secs=0.1, straggler_persist_k=1,
                                     straggler_window_n=1), scraper=Skew())
    assert sup.run() == 0 and actions(sup) == [policy.DONE]
    events = read_events(sup)
    verdicts = [e["args"] for e in events if e["name"] == "straggler_persistent"]
    assert verdicts and all(v["mitigate"] is False for v in verdicts)
    # the sidecar answered every poll: its state is recorded once
    assert [e["args"]["ok"] for e in events if e["name"] == "sidecar_scrape"] == [True]


def test_a_sidecar_that_never_answers_is_recorded_once(tmp_path, saved_pth):
    cmd, log, ws = scripted(tmp_path, saved_pth, "time.sleep(0.5)\nsys.exit(0)")
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.02,
                                     metrics_port=port, stall_secs=30.0))
    assert sup.run() == 0 and actions(sup) == [policy.DONE]
    scrapes = [e["args"] for e in read_events(sup) if e["name"] == "sidecar_scrape"]
    assert scrapes == [{"ok": False, "url": f"http://127.0.0.1:{port}/metrics"}]


def test_a_relayed_sigterm_shuts_down_with_the_childs_code(tmp_path, saved_pth):
    body = """
signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
open(os.path.join(run_dir, "ready"), "w").close()
time.sleep(60)
"""
    cmd, log, ws = scripted(tmp_path, saved_pth, body)
    sup = Supervisor(SuperviseConfig(command=cmd, workdir=str(ws), poll_s=0.02))
    join = run_in_thread(sup)
    wait_for(lambda: os.path.exists(ws / "synthetic_models" / RUN / "ready"), "the child")
    # a resize filed now is left over when the run ends: it must not survive
    with open(os.path.join(sup.supervise_dir, "resize_request"), "w") as f:
        f.write("")  # empty: caught mid-write, left for the next poll
    sup._handle_signal(signal.SIGTERM, None)
    assert join() == 75
    assert actions(sup) == [policy.SHUTDOWN]
    assert not os.path.exists(os.path.join(sup.supervise_dir, "resize_request"))
    assert "resize_request_discarded" in [e["name"] for e in read_events(sup)]


def test_the_cli_exits_with_the_final_childs_code(tmp_path, saved_pth):
    cmd, log, ws = scripted(tmp_path, saved_pth, "sys.exit(3)")
    assert cli_main(["--workdir", str(ws), "--poll_secs", "0.02", "--"] + cmd) == 3
    with pytest.raises(SystemExit) as exc:
        cli_main(["--workdir", str(ws)])
    assert exc.value.code == 2


# ------------------------------------------------------- the port's trainer

TRAINER = ["--images", "64", "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10",
           "--size", "8", "--batch_size", "16", "--learning_rate", "0.05", "--temp", "0.5",
           "--print_freq", "1", "--feat_dim", "16", "--epochs", "2", "--save_freq", "1",
           "--ngpu", "auto"]


def victim(ws, *extra):
    return [sys.executable, VICTIM] + TRAINER + ["--workdir", str(ws)] + list(extra)


def supervise(ws, command, **kw):
    kw.setdefault("poll_s", 0.1)
    kw.setdefault("backoff_base_s", 0.05)
    return Supervisor(SuperviseConfig(command=command, workdir=str(ws), **kw))


def final_state(ws):
    run_dir = launch.find_resume_dir(str(ws), require_checkpoint=True)
    ckpt = torch.load(os.path.join(run_dir, "last.pth"), map_location="cpu", weights_only=True)
    return ckpt["model"], ckpt["step"]


def test_a_nan_backs_off_and_resumes(tmp_path):
    ws = tmp_path / "ws"
    sup = supervise(ws, victim(ws, "--fault", "nan", "--fault_step", "6",
                               "--fault_marker", str(tmp_path / "nan.marker")))
    assert sup.run() == 0
    assert actions(sup) == [policy.BACKOFF_RESTART, policy.DONE]
    events = read_events(sup)
    assert [e["args"]["rc"] for e in events if e["name"] == "child_run"] == [1, 0]
    launches = [e["args"] for e in events if e["name"] == "launch"]
    assert launches[1]["resume"]  # from the crash save
    assert final_state(ws)[1] == 8


def test_a_collapse_gives_up_with_3(tmp_path):
    ws = tmp_path / "ws"
    sup = supervise(ws, victim(ws, "--fault", "collapse", "--health_freq", "1",
                               "--health_policy", "abort"), max_restarts=3)
    assert sup.run() == 3
    assert actions(sup) == [policy.GIVE_UP]


def straight_run(ws, monkeypatch):
    """The victim's run with no fault and no supervisor, in this process
    with the children's one thread (a step's sums then run in their order)."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon

    load = supcon.load_dataset

    def first_64(*a, **kw):
        train, test, n_cls = load(*a, **kw)
        return {k: v[:64] for k, v in train.items()}, test, n_cls

    monkeypatch.setattr(supcon, "load_dataset", first_64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        supcon.main(TRAINER[2:] + ["--workdir", str(ws)])
    finally:
        torch.set_num_threads(threads)


def test_kill_9_in_epoch_2_resumes_bitwise(tmp_path, monkeypatch):
    straight_ws = tmp_path / "straight"
    straight_run(straight_ws, monkeypatch)
    ws, marker = tmp_path / "ws", tmp_path / "hold.marker"
    sup = supervise(ws, victim(ws, "--fault", "hold", "--fault_step", "6",
                               "--fault_marker", str(marker)))
    join = run_in_thread(sup)
    wait_for(marker.exists, "step 6")
    os.kill(sup.child.pid, signal.SIGKILL)
    assert join() == 0
    assert actions(sup) == [policy.BACKOFF_RESTART, policy.DONE]
    assert [e["args"]["rc"] for e in read_events(sup) if e["name"] == "child_run"] == [-9, 0]
    got, got_step = final_state(ws)
    want, want_step = final_state(straight_ws)
    assert got_step == want_step == 8
    assert got.keys() == want.keys()
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


def test_a_resize_relaunches_torchrun_at_one_process(tmp_path):
    ws, marker = tmp_path / "ws", tmp_path / "hold.marker"
    command = ([sys.executable, "-m", "simclr_pytorch_distributed_tpu_torch.parallel.torchrun",
                "--standalone"] + victim(ws, "--fault", "hold", "--fault_step", "2",
                                        "--fault_marker", str(marker))[1:])
    sup = supervise(ws, command, devices=2, grace_secs=60.0)
    join = run_in_thread(sup)
    wait_for(marker.exists, "step 2")
    with open(os.path.join(sup.supervise_dir, "resize_request"), "w") as f:
        f.write("1")
    assert join() == 0
    assert actions(sup) == [policy.RESTART_RESIZED, policy.DONE]
    assert sup.decisions[0].devices == 1 and sup.decisions[0].delay_s == 0
    launches = [e["args"] for e in read_events(sup) if e["name"] == "launch"]
    assert [la["devices"] for la in launches] == [2, 1] and launches[1]["resume"]
    # both processes saved and voted at one boundary: the preempt save
    assert glob.glob(str(ws / "*" / "*" / "preempt_epoch_1_step_2.pth"))
    assert final_state(ws)[1] == 8


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_persistent_straggler_is_rebalanced_and_changes_nothing(tmp_path):
    ws = tmp_path / "ws"
    port = free_port()
    command = [sys.executable, FLEET, "--workdir", str(ws), "--epochs", "2",
               "--metrics_port", str(port), "--straggler_ms", "150",
               "--straggler_marker", str(tmp_path / "straggler.marker")]
    sup = supervise(ws, command, max_restarts=3, poll_s=0.25, grace_secs=120.0,
                    metrics_port=port, straggler_skew_secs=0.05, straggler_persist_k=3,
                    straggler_window_n=5, straggler_mitigate=True)
    assert sup.run() == 0
    assert actions(sup) == [policy.RESTART_REBALANCED, policy.DONE]
    events = read_events(sup)
    findings = [e["args"] for e in events if e["name"] == "straggler_finding"]
    assert findings and all(f["straggler"] == 1 and f["processes"] == 2 for f in findings)
    assert [e["args"]["share"] for e in events if e["name"] == "launch"] == [None, "1:0.5"]
    result = json.load(open(ws / "fleet_result.json"))
    assert result["share_hint"] == "1:0.5" and not result["straggler_armed"]

    control = tmp_path / "control"
    subprocess.run([sys.executable, FLEET, "--workdir", str(control), "--epochs", "2"],
                   check=True, timeout=300, stdout=subprocess.DEVNULL)
    want = json.load(open(control / "fleet_result.json"))
    digests = [(w["step"], w["digest"]) for w in result["workers"]]
    assert digests == [(w["step"], w["digest"]) for w in want["workers"]]
    assert digests[0] == digests[1] and digests[0][0] == 8
    shutil.rmtree(ws, ignore_errors=True)
