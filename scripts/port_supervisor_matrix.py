#!/usr/bin/env python
"""The supervisor scenario matrix of the PyTorch/CUDA port: the port's
supervisor (``supervise.Supervisor``) babysitting the port's trainer
(``train.supcon`` through ``scripts/port_supervisor_victim.py``, ``--conv_impl
auto``, so the fused kernels at world size 1 on the card) through six
failure shapes, and the fleet-merge artifact of a real two-process run. The
port of the JAX package's ``scripts/supervisor_matrix.py``.

    python3 scripts/port_supervisor_matrix.py \\
        --json docs/evidence/port_supervisor_r21.json \\
        --chaos_json docs/evidence/port_chaos_matrix_r21.json \\
        --fleet_json docs/evidence/port_fleet_report_r21.json

Each scenario runs in its own workdir and ends in exactly the JAX matrix's
decision sequence:

- ``sigkill``: SIGKILL of the trainer in epoch 2 (held after a step, so the
  kill lands mid-run): ``backoff_restart, done``;
- ``stall``: the trainer's main thread wedges at its third flush boundary
  and absorbs SIGTERM; the trainer's watchdog dumps its stacks, the
  supervisor reads the scraped boundary age and the dump, and the grace
  window lapses to SIGKILL: ``backoff_restart, done``;
- ``collapse``: impossible health bars under ``--health_policy abort``:
  exit 3 after an observed ``health_alarm``, ``give_up``;
- ``preempt_resize``: a ``resize_request`` of 1 reaches a two-process fleet
  (``scripts/port_fleet_launcher.py --trainer``), which saves and exits 75;
  the relaunch resumes on one process: ``restart_resized, done``, and the
  launches' ``devices`` change;
- ``straggler``: the same fleet with process 1 paced 150 ms at every
  boundary exchange; the skew gauges on rank 0's sidecar give a
  persistence verdict, the mitigation preempts, the relaunch carries the
  share hint: ``restart_rebalanced, done``; the final parameter digests
  equal those of a policy-off control run of the same launcher
  (``--deterministic``: cuDNN's deterministic algorithms on both);
- ``chaos``: straggler, SIGKILL of a process of the rebalanced fleet, and
  an injected collapse under ``--health_policy warn`` in one supervised
  lifetime: ``restart_rebalanced, backoff_restart, done``.

The fleet legs run one process a card over NCCL where the machine has two
cards or more, else two gloo processes on the one card (or the CPU under
``--device cpu``); the artifacts record the card's name and power limit
(``nvidia-smi``), the card count and the backend. ``--fleet_json``
additionally runs the two-process fleet for one epoch with the flight
recorder on and merges its per-process streams with
``scripts/port_trace_report.py --fleet``.

Prints one JSON line a scenario; exits 1 if a scenario or the merge is not
ok. ``--device cpu --model resnet10 --size 8 --batch_size 16 --images 64``
is the CPU geometry of the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simclr_pytorch_distributed_tpu_torch.parallel.torchrun import child_pids  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.supervise.supervisor import (  # noqa: E402
    SuperviseConfig,
    Supervisor,
)

VICTIM = os.path.join(REPO, "scripts", "port_supervisor_victim.py")
LAUNCHER = os.path.join(REPO, "scripts", "port_fleet_launcher.py")
TRACE_REPORT = os.path.join(REPO, "scripts", "port_trace_report.py")
WAIT_S = 900.0  # per-wait ceiling
CHAOS_NAMES = ("straggler", "chaos")
CHAOS_SCHEMA = "chaos_matrix/v1"
# the stall leg: the watchdog's deadline must pass a child's start-up to its
# first boundary (imports, CUDA, the first step); the supervisor's liveness
# deadline is longer, so the watchdog's dump is what it sees first
WATCHDOG_S, STALL_S, STALL_GRACE_S = 15.0, 25.0, 5.0
STRAGGLER_MS = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(predicate, what: str, timeout_s: float = WAIT_S):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise RuntimeError(f"timeout waiting for {what}")


def card_fields(device: str) -> dict:
    """The card's name and power limit, the card count, or the CPU."""
    if device == "cpu":
        return {"device": "cpu", "card": None, "card_count": 0}
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"device": "cuda", "card": out.stdout.strip().splitlines()[0],
            "card_count": torch.cuda.device_count()}


def fleet_backend(device: str, nproc: int = 2) -> str:
    """The backend ``port_fleet_launcher.py --trainer`` picks for ``nproc``
    processes."""
    if device == "cpu":
        return "gloo"
    import torch
    return "nccl" if torch.cuda.device_count() >= nproc else "gloo"


class Matrix:
    """The scenarios over one trainer geometry (``args``)."""

    def __init__(self, args):
        self.args = args
        self.base = args.workdir
        self.steps_per_epoch = -(-(args.images or 1792) // args.batch_size)

    def trainer_argv(self, workdir, epochs, trial):
        a = self.args
        argv = ["--device", a.device, "--dataset", "synthetic", "--model", a.model,
                "--size", str(a.size), "--batch_size", str(a.batch_size),
                "--epochs", str(epochs), "--method", "SimCLR", "--temp", "0.5",
                "--learning_rate", str(a.learning_rate), "--conv_impl", "auto",
                "--loss_impl", "auto", "--print_freq", "1", "--save_freq", "1",
                "--ngpu", "auto", "--workdir", workdir, "--trial", trial]
        if a.bf16:
            argv.append("--bf16")
        if a.images:
            argv += ["--images", str(a.images)]
        if a.feat_dim:
            argv += ["--feat_dim", str(a.feat_dim)]
        return argv

    def victim(self, workdir, epochs, trial, *extra):
        return ([sys.executable, VICTIM] + self.trainer_argv(workdir, epochs, trial)
                + list(extra) + ["--kernels_log", kernels_log(workdir)])

    def fleet(self, workdir, epochs, trial, launcher_flags=(), victim_flags=()):
        return ([sys.executable, LAUNCHER, "--trainer", "--workdir", workdir]
                + list(launcher_flags) + ["--"] + list(victim_flags)
                + ["--kernels_log", kernels_log(workdir)]
                + self.trainer_argv(workdir, epochs, trial))

    def workdir(self, name):
        wd = os.path.join(self.base, name)
        # fresh: a one-shot marker left by an earlier run disarms its fault
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
        return wd


def kernels_log(workdir: str) -> str:
    return os.path.join(workdir, "kernels.jsonl")


def kernel_launches(workdir: str) -> dict:
    """The fused kernels every trainer process under ``workdir`` launched:
    each process's last report, summed (a SIGKILLed process counts to its
    last epoch's end)."""
    last = {}
    if os.path.exists(kernels_log(workdir)):
        with open(kernels_log(workdir)) as fh:
            for line in fh:
                rec = json.loads(line)
                last[rec["pid"]] = rec["kernels"]
    total = {}
    for launches in last.values():
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return dict(sorted(total.items()))


def run_supervisor(cfg: SuperviseConfig):
    """The supervisor on a thread; returns ``(supervisor, join)``."""
    sup = Supervisor(cfg)
    box = {}
    thread = threading.Thread(target=lambda: box.update(rc=sup.run()), name="supervisor",
                              daemon=True)
    thread.start()

    def join(timeout_s: float = WAIT_S) -> int:
        thread.join(timeout_s)
        if thread.is_alive():
            raise RuntimeError("the supervisor did not finish")
        return box["rc"]

    return sup, join


def events_of(sup: Supervisor):
    with open(sup.recorder._path) as fh:
        return [json.loads(line) for line in fh]


def timings(events) -> dict:
    """Seconds on the supervisor's clock: from the first child's end to the
    second launch (the decision, its backoff or grace, the spawn), and to
    the last child's end (the recovery to a finished job)."""
    ends = [e["ts"] + e["dur"] for e in events if e["name"] == "child_run"]  # spans
    launches = [e["ts"] for e in events if e["name"] == "launch"]
    out = {"supervised_s": round(ends[-1], 3) if ends else None}
    if len(ends) > 1 and len(launches) > 1:
        out["relaunch_s"] = round(launches[1] - ends[0], 3)
        out["recovery_s"] = round(ends[-1] - ends[0], 3)
    return out


def record(name, sup, rc, expect, detail=None):
    actions = [d.action for d in sup.decisions]
    events = events_of(sup)
    rec = {
        "scenario": name,
        "rc": rc,
        "decisions": actions,
        "expected_decisions": list(expect),
        "attempts": sum(1 for e in events if e["name"] == "launch"),
        "events_file": os.path.relpath(sup.recorder._path, REPO),
        "n_events": len(events),
        "ok": actions == list(expect),
        **timings(events),
        **(detail or {}),
    }
    return rec, events


def health_alarms(events):
    return [e for e in events if e["name"] == "trainer_event"
            and e.get("args", {}).get("event") == "health_alarm"]


def supervise(command, workdir, **kw):
    kw.setdefault("max_restarts", 3)
    kw.setdefault("backoff_base_s", 0.2)
    kw.setdefault("poll_s", 0.25)
    return SuperviseConfig(command=command, workdir=workdir, **kw)


def scenario_sigkill(m: Matrix):
    wd = m.workdir("sigkill")
    marker = os.path.join(wd, "hold.marker")
    sup, join = run_supervisor(supervise(
        m.victim(wd, 2, "k9", "--fault", "hold", "--fault_step", str(m.steps_per_epoch + 3),
                 "--fault_marker", marker), wd))
    wait_for(lambda: os.path.exists(marker), "the hold in epoch 2")
    pid = sup.child.pid
    os.kill(pid, signal.SIGKILL)
    rc = join()
    rec, events = record("sigkill", sup, rc, ["backoff_restart", "done"],
                         {"killed_pid": pid})
    codes = [e["args"]["rc"] for e in events if e["name"] == "child_run"]
    rec["child_codes"] = codes
    rec["ok"] = bool(rec["ok"] and rc == 0 and codes[:1] == [-signal.SIGKILL])
    return rec


def scenario_stall(m: Matrix):
    wd = m.workdir("stall")
    port = free_port()
    sup, join = run_supervisor(supervise(
        m.victim(wd, 1, "stall", "--fault", "stall", "--fault_step", "3",
                 "--fault_marker", os.path.join(wd, "stall.marker"),
                 "--metrics_port", str(port), "--watchdog_secs", str(WATCHDOG_S)),
        wd, stall_secs=STALL_S, grace_secs=STALL_GRACE_S, metrics_port=port))
    rc = join()
    rec, events = record("stall", sup, rc, ["backoff_restart", "done"])
    stalls = [e for e in events if e["name"] == "liveness_stall"]
    dumps = [e for e in events if e["name"] == "stall_dump_observed"]
    rec["liveness_stalls"] = len(stalls)
    rec["watchdog_dumps_observed"] = len(dumps)
    rec["stall_verdicts"] = [e.get("args", {}) for e in stalls]
    rec["ok"] = bool(rec["ok"] and rc == 0 and stalls and dumps)
    return rec


def scenario_collapse(m: Matrix):
    wd = m.workdir("collapse")
    sup, join = run_supervisor(supervise(
        m.victim(wd, 1, "collapse", "--fault", "collapse", "--health_freq", "1",
                 "--health_policy", "abort"), wd))
    rc = join()
    rec, events = record("collapse", sup, rc, ["give_up"])
    rec["health_alarms_observed"] = len(health_alarms(events))
    rec["ok"] = bool(rec["ok"] and rc == 3 and rec["health_alarms_observed"])
    return rec


def scenario_preempt_resize(m: Matrix, devices_before=2, devices_after=1):
    wd = m.workdir("preempt_resize")
    marker = os.path.join(wd, "hold.marker")
    sup, join = run_supervisor(supervise(
        m.fleet(wd, 2, "resize", victim_flags=[
            "--fault", "hold", "--fault_step", str(m.steps_per_epoch + 2),
            "--fault_marker", marker]),
        wd, grace_secs=120.0, devices=devices_before))
    wait_for(lambda: os.path.exists(marker), "the hold in epoch 2")
    with open(os.path.join(sup.supervise_dir, "resize_request"), "w") as fh:
        fh.write(str(devices_after))
    rc = join()
    rec, events = record("preempt_resize", sup, rc, ["restart_resized", "done"], {
        "devices_before": devices_before, "devices_after": devices_after,
        "backend_before": fleet_backend(m.args.device, devices_before),
        "backend_after": fleet_backend(m.args.device, devices_after)})
    launches = [e["args"] for e in events if e["name"] == "launch"]
    rec["launch_devices"] = [la.get("devices") for la in launches]
    resized = [la for la in launches if la.get("devices") == devices_after]
    rec["resumed_resized"] = bool(resized and resized[0].get("resume"))
    rec["ok"] = bool(rec["ok"] and rc == 0 and rec["resumed_resized"])
    return rec


def straggler_config(command, wd, port):
    # bar 0.05 s under the paced 0.15 s; 3 of the last 5 boundaries; the
    # grace covers SIGTERM -> the collective vote -> the save -> exit 75
    return supervise(command, wd, straggler_skew_secs=0.05, straggler_persist_k=3,
                     straggler_window_n=5, straggler_mitigate=True, grace_secs=120.0,
                     metrics_port=port)


def pacing(wd, port):
    return ["--metrics_port", str(port), "--straggler_ms", str(STRAGGLER_MS),
            "--straggler_pid", "1", "--straggler_marker", os.path.join(wd, "straggler.marker")]


def scenario_straggler(m: Matrix):
    wd = m.workdir("straggler")
    port = free_port()
    epochs = m.args.straggler_epochs
    sup, join = run_supervisor(straggler_config(
        m.fleet(wd, epochs, "straggler", pacing(wd, port), ["--deterministic"]), wd, port))
    rc = join()
    rec, events = record("straggler", sup, rc, ["restart_rebalanced", "done"],
                         {"backend": fleet_backend(m.args.device)})
    findings = [e for e in events if e["name"] == "straggler_finding"]
    verdicts = [e for e in events if e["name"] == "straggler_persistent"]
    mitigations = [e for e in events if e["name"] == "straggler_mitigation"]
    rec["straggler_findings"] = len(findings)
    rec["persistence_verdicts"] = len(verdicts)
    rec["mitigation_events"] = len(mitigations)
    rec["launch_shares"] = [e["args"].get("share") for e in events if e["name"] == "launch"]
    path = os.path.join(wd, "fleet_result.json")
    result = json.load(open(path)) if os.path.exists(path) else {}
    rec["share_hint_carried"] = result.get("share_hint", "")
    hint_ok = bool(rec["share_hint_carried"]
                   and rec["share_hint_carried"] in rec["launch_shares"])
    # the same fleet, unsupervised and unpaced, must end on the same digests
    wd_c = m.workdir("straggler_control")
    with open(os.path.join(wd_c, "control.log"), "w") as log:
        subprocess.run(m.fleet(wd_c, epochs, "straggler", victim_flags=["--deterministic"]),
                       check=True, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                       timeout=WAIT_S)
    control = json.load(open(os.path.join(wd_c, "fleet_result.json")))
    rec["digests"] = [w.get("digest") for w in result.get("workers", [])]
    rec["control_digests"] = [w.get("digest") for w in control["workers"]]
    rec["steps"] = [w.get("step") for w in result.get("workers", [])]
    rec["bit_identical"] = bool(rec["digests"] and rec["digests"] == rec["control_digests"])
    rec["ok"] = bool(rec["ok"] and rc == 0 and findings and verdicts
                     and len(mitigations) >= 2 and hint_ok and rec["bit_identical"])
    return rec


def scenario_chaos(m: Matrix):
    wd = m.workdir("chaos")
    port = free_port()
    # impossible health bars under warn: every health window alarms, none aborts
    sup, join = run_supervisor(straggler_config(
        m.fleet(wd, m.args.straggler_epochs, "chaos", pacing(wd, port),
                ["--fault", "collapse", "--health_freq", "2", "--health_policy", "warn"]),
        wd, port))
    first = wait_for(lambda: sup.child and sup.child.pid, "the first fleet")

    def rebalanced_workers():
        if not sup.decisions or sup.decisions[0].action != "restart_rebalanced":
            return None
        child = sup.child
        if not child or child.pid == first or child.poll() is not None:
            return None
        workers = child_pids(child.pid)
        return workers if len(workers) >= 2 else None

    workers = wait_for(rebalanced_workers, "the rebalanced fleet's processes")
    killed = max(workers)
    os.kill(killed, signal.SIGKILL)
    rc = join()
    rec, events = record("chaos", sup, rc, ["restart_rebalanced", "backoff_restart", "done"],
                         {"killed_pid": killed, "backend": fleet_backend(m.args.device)})
    mitigations = [e for e in events if e["name"] == "straggler_mitigation"]
    rec["health_alarms_observed"] = len(health_alarms(events))
    rec["mitigation_events"] = len(mitigations)
    rec["child_codes"] = [e["args"]["rc"] for e in events if e["name"] == "child_run"]
    rec["ok"] = bool(rec["ok"] and rc == 0 and rec["health_alarms_observed"]
                     and len(mitigations) >= 2)
    return rec


SCENARIOS = {
    "sigkill": scenario_sigkill,
    "stall": scenario_stall,
    "collapse": scenario_collapse,
    "preempt_resize": scenario_preempt_resize,
    "straggler": scenario_straggler,
    "chaos": scenario_chaos,
}


def fleet_report(m: Matrix) -> dict:
    """One epoch of the two-process fleet (process 1 paced, the flight
    recorder on), merged by ``scripts/port_trace_report.py --fleet``."""
    wd = m.workdir("fleet_report")
    with open(os.path.join(wd, "fleet.log"), "w") as log:
        subprocess.run(m.fleet(wd, 1, "fleet_report", [
            "--straggler_ms", str(STRAGGLER_MS), "--straggler_pid", "1"]),
            check=True, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, timeout=WAIT_S)
    result = json.load(open(os.path.join(wd, "fleet_result.json")))
    run_dir = result["workers"][0]["save_folder"]
    out = os.path.join(wd, "fleet_report.json")
    proc = subprocess.run([sys.executable, TRACE_REPORT, "--fleet", run_dir, "--json", out],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    with open(os.path.join(wd, "fleet_report.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    artifact = json.load(open(out))
    artifact["run_dir"] = os.path.relpath(run_dir, REPO)
    artifact.update(nproc=result["nproc"], backend=result["backend"],
                    report_exit=proc.returncode,
                    trainer=m.trainer_argv(os.path.relpath(wd, REPO), 1, "fleet_report"))
    return artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "work_space", "port_supervisor_matrix"))
    ap.add_argument("--json", default="", help="the four single-process scenarios' artifact")
    ap.add_argument("--chaos_json", default="", help="the straggler and chaos artifact")
    ap.add_argument("--fleet_json", default="",
                    help="run the two-process fleet-merge leg and write its artifact here")
    ap.add_argument("--scenarios", nargs="*", default=list(SCENARIOS), choices=list(SCENARIOS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--learning_rate", type=float, default=0.5)
    ap.add_argument("--images", type=int, default=0,
                    help="cut the synthetic set to its first N images (0 = all 1792)")
    ap.add_argument("--feat_dim", type=int, default=0)
    ap.add_argument("--straggler_epochs", type=int, default=4,
                    help="epochs of the straggler and chaos fleets")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("port_supervisor_matrix: no CUDA device", file=sys.stderr)
            return 2
    os.makedirs(args.workdir, exist_ok=True)
    # a failed producer must never leave a stale green artifact behind
    for path in (args.json, args.chaos_json, args.fleet_json):
        if path and os.path.exists(path):
            os.remove(path)
    card = card_fields(args.device)
    print(f"card: {card}", flush=True)
    m = Matrix(args)
    trainer = {"model": args.model, "bf16": args.bf16, "batch_size": args.batch_size,
               "size": args.size, "conv_impl": "auto", "images": args.images or 1792}
    scenarios = {}
    for name in args.scenarios:
        t0 = time.time()
        rec = SCENARIOS[name](m)
        rec["wall_s"] = round(time.time() - t0, 3)
        rec["kernel_launches"] = kernel_launches(os.path.join(m.base, name))
        print(json.dumps(rec), flush=True)
        scenarios[name] = rec
    ok = all(r["ok"] for r in scenarios.values())
    single = {k: v for k, v in scenarios.items() if k not in CHAOS_NAMES}
    chaos = {k: v for k, v in scenarios.items() if k in CHAOS_NAMES}
    common = {"victim": os.path.relpath(VICTIM, REPO), "trainer": trainer, **card}
    if args.json and single:
        with open(args.json, "w") as fh:
            json.dump({"metric": "supervisor_matrix", "scenarios": single,
                       "ok": all(r["ok"] for r in single.values()), **common,
                       "fleet_backend": fleet_backend(args.device)}, fh, indent=1)
    if args.chaos_json and chaos:
        with open(args.chaos_json, "w") as fh:
            json.dump({"metric": "chaos_matrix", "schema": CHAOS_SCHEMA,
                       "launcher": os.path.relpath(LAUNCHER, REPO), "scenarios": chaos,
                       "ok": all(r["ok"] for r in chaos.values()), **common,
                       "backend": fleet_backend(args.device)}, fh, indent=1)
    if args.fleet_json:
        t0 = time.time()
        artifact = fleet_report(m)
        artifact.update(card)
        artifact["wall_s"] = round(time.time() - t0, 3)
        artifact["kernel_launches"] = kernel_launches(os.path.join(m.base, "fleet_report"))
        with open(args.fleet_json, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(json.dumps({"metric": "fleet_report", "ok": artifact["ok"],
                          "sessions": sorted(artifact["sessions"]),
                          "backend": artifact["backend"]}), flush=True)
        ok = ok and artifact["ok"]
    print(json.dumps({"metric": "port_supervisor_matrix", "ok": ok, **card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
