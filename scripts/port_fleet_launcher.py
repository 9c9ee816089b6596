#!/usr/bin/env python
"""One supervisable command that owns a real multi-process gloo fleet of the
port's trainer: the straggler scenario's child.

    python scripts/port_fleet_launcher.py --workdir DIR [--nproc 2] [--epochs 4]
        [--metrics_port N] [--straggler_ms MS --straggler_pid P
        --straggler_marker FILE] [--resume RUN_DIR]

The supervisor babysits one child process, but the straggler signal comes
from the boundary exchange of several processes (``utils/telemetry.py``).
This launcher is the bridge, the one-host stand-in for a scheduler's fleet
launcher:

- it starts ``--nproc`` processes of ``tests/torch_parallel_child.py``
  suite ``fleet`` (the port's pretraining driver over gloo, with its
  epoch loop, collective saves and preemption vote), in a fresh rendezvous
  folder each launch;
- process 0 serves its ``/metrics`` sidecar on ``--metrics_port``, so the
  supervisor scrapes the real fleet's skew gauges
  (``train_boundary_skew_seconds``, ``train_boundary_straggler``,
  ``train_process_count``);
- with ``--straggler_ms`` one process arrives that late at every boundary,
  behind a one-shot ``--straggler_marker`` written at launch, so the
  supervisor's relaunch of this command runs clean;
- it passes SIGTERM and SIGINT on to the processes, whose preemption vote
  stops them all at one boundary with a save and exit 75, and then exits 75
  itself: the clean preemption the supervisor's policy expects;
- it forwards the supervisor's appended ``--resume <run_dir>``;
- it reads ``FLEET_SHARE_HINT`` (``data/pipeline.FLEET_SHARE_ENV``), the
  rebalance hint a ``restart_rebalanced`` relaunch carries, and on a
  completed run writes it into ``<workdir>/fleet_result.json`` beside each
  process's final step and model digest.

Exit code: 75 when the processes were preempted, 0 when all completed, else
the first failure's code (signal deaths as the shell's 128+N).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_parallel_child.py")
sys.path.insert(0, REPO)

_terminate = {"flag": False}


def _handle_term(signum, frame):  # noqa: ARG001 - signal handler signature
    _terminate["flag"] = True


def parse_args(argv=None):
    p = argparse.ArgumentParser("supervised gloo fleet of the port's trainer")
    p.add_argument("--workdir", required=True)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--resume", default="",
                   help="forwarded to every process (the supervisor appends it on "
                        "relaunches; argparse last-wins)")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="process 0's /metrics sidecar (the supervisor's scrape target)")
    p.add_argument("--straggler_ms", type=float, default=0.0,
                   help="delay this process's arrival at every boundary exchange")
    p.add_argument("--straggler_pid", type=int, default=1,
                   help="which process straggles")
    p.add_argument("--straggler_marker", default="",
                   help="one-shot gate: the delay arms only while this file is absent")
    return p.parse_args(argv)


def main(argv=None):
    from simclr_pytorch_distributed_tpu_torch.data.pipeline import FLEET_SHARE_ENV
    from simclr_pytorch_distributed_tpu_torch.parallel.torchrun import shell_code

    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    armed = args.straggler_ms > 0 and not (
        args.straggler_marker and os.path.exists(args.straggler_marker))
    env.pop("FLEET_STRAGGLER_MS", None)
    if armed:
        env["FLEET_STRAGGLER_MS"] = str(args.straggler_ms)
        env["FLEET_STRAGGLER_PID"] = str(args.straggler_pid)
        if args.straggler_marker:
            with open(args.straggler_marker, "w") as f:
                f.write(f"straggler {args.straggler_ms}ms")
        print(f"FLEET straggler armed: p{args.straggler_pid} +{args.straggler_ms}ms a boundary",
              flush=True)
    share_hint = env.get(FLEET_SHARE_ENV, "")
    if share_hint:
        print(f"FLEET share hint: {share_hint}", flush=True)

    # a fresh rendezvous folder each launch: a relaunch must not meet the
    # previous launch's file store
    rendezvous = os.path.join(args.workdir, f"rendezvous_{time.time_ns()}")
    os.makedirs(rendezvous)
    spec = json.dumps({"workdir": args.workdir, "epochs": args.epochs, "resume": args.resume})
    procs, logs = [], []
    for i in range(args.nproc):
        child_env = dict(env)
        child_env.pop("CHILD_METRICS_PORT", None)
        if i == 0 and args.metrics_port:
            child_env["CHILD_METRICS_PORT"] = str(args.metrics_port)
        log_path = os.path.join(rendezvous, f"fleet_p{i}.log")
        logs.append(log_path)
        with open(log_path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, str(i), str(args.nproc), rendezvous, "fleet", spec],
                env=child_env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    print(f"FLEET launched: {args.nproc} processes, pids {[p.pid for p in procs]}", flush=True)

    previous = {s: signal.signal(s, _handle_term) for s in (signal.SIGTERM, signal.SIGINT)}
    relayed = False
    try:
        while any(p.poll() is None for p in procs):
            if _terminate["flag"] and not relayed:
                relayed = True
                print("FLEET passing SIGTERM to the processes", flush=True)
                for p in procs:
                    if p.poll() is None:
                        try:
                            p.send_signal(signal.SIGTERM)
                        except OSError:
                            pass
            time.sleep(0.1)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for p in procs:
            if p.poll() is None:  # never orphan a process
                p.kill()
                p.wait()

    rcs = [p.returncode for p in procs]
    workers = []
    for i, log_path in enumerate(logs):
        entry = {"process": i, "rc": rcs[i]}
        with open(log_path) as f:
            text = f.read()
        sys.stdout.write(text)
        for line in text.splitlines():
            if line.startswith("DRIVER "):
                fields = dict(kv.split("=", 1) for kv in line.split()[1:])
                entry.update(step=int(fields["step"]), digest=fields["digest"],
                             save_folder=fields["save_folder"])
        workers.append(entry)
    sys.stdout.flush()
    if all(rc == 0 for rc in rcs):
        result_json = os.path.join(args.workdir, "fleet_result.json")
        with open(result_json, "w") as f:
            json.dump({"nproc": args.nproc, "epochs": args.epochs, "resume": args.resume,
                       "share_hint": share_hint, "straggler_armed": armed,
                       "workers": workers}, f, indent=1)
        print(f"FLEET done: {result_json}", flush=True)
        return 0
    if 75 in rcs:
        print("FLEET preempted (exit 75, state saved)", flush=True)
        return 75
    return shell_code(next(rc for rc in rcs if rc != 0))


if __name__ == "__main__":
    sys.exit(main())
