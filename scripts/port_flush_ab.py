"""A/B of the port's telemetry flush on one CUDA card, and of a parent
checkout of the port against this one.

    python3 scripts/port_flush_ab.py [--config plain|large_batch_a]
        [--model resnet50] [--rounds 2] [--parent DIR] [--also LABEL=DIR]
        [--trace]

Each run is one 7-step epoch of ``--dataset synthetic`` at the recipe's
width (batch 256, 32 px, ``--conv_impl fused --loss_impl fused``, fp32)
through ``train.supcon.main``, for SGD and for LARS. The configurations:

- ``plain`` (no process group): the flush once a window on the background
  thread (``async10``: ``--telemetry async --print_freq 10``, the default)
  against the flush inline after every step (``sync1``: ``--telemetry sync
  --print_freq 1``, the host waiting for each step as the per-step
  metrics readback before the metric ring did);
- ``large_batch_a``: ``chip_smoke.py``'s large_batch (a) configuration,
  under torchrun's environment at world size 1 (NCCL) with ``--syncBN``;
  the arms ``async1`` (``--telemetry async --print_freq 1``, what
  ``chip_smoke.py`` runs), ``sync1`` and ``async10``.

``--parent DIR`` adds the arm ``parent``: the same run through the port in
the checkout ``DIR`` (one without the telemetry flags, so its own
defaults: ``--print_freq 1``); ``--also LABEL=DIR`` (repeatable) runs the
configuration's arms through the port in another checkout that has the
telemetry flags. Every arm runs in a child process that
imports the port of its own checkout and patches its ``train_step`` to
record, before each step, a CUDA event on the current stream and the
host's clock, and to time each optimizer step on the host. A run reports
the median over steps 3-6 of the device's period (event to event) and of
the host's time inside ``train_step`` and inside the optimizer step:
when the host's time inside the step nears the period, the host is held
back, not ahead of the card. For each round the checkouts run in turns,
forward then backward (parent, others, this, this, others, parent), and a
child runs its arms in turns too.

``--trace`` then takes one ``torch.profiler`` window of steps 3-5 of the
LARS run in each arm of each checkout (the window's edges synchronize the
card, so these runs are not timed), into a temporary directory, and
summarizes each with ``chip_smoke.py``'s ``trace_summary``.

Prints the card's name and power limit, one JSON line per run, one per
arm with the medians, and the trace summaries. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARMS = {"async10": ["--telemetry", "async", "--print_freq", "10"],
        "async1": ["--telemetry", "async", "--print_freq", "1"],
        "sync1": ["--telemetry", "sync", "--print_freq", "1"],
        "parent": ["--print_freq", "1"]}
CONFIG_ARMS = {"plain": ("async10", "sync1"), "large_batch_a": ("async1", "sync1", "async10")}
OPTIMIZERS = ("sgd", "lars")
TIMED = slice(2, 6)  # the periods of steps 3-6
TRACE_FIRST, TRACE_STEPS = 3, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_argv(model: str, optimizer: str, arm: str, config: str, workdir: str):
    argv = ["--dataset", "synthetic", "--model", model, "--batch_size", "256", "--size", "32",
            "--epochs", "1", "--method", "SimCLR", "--temp", "0.5", "--learning_rate", "0.5",
            "--cosine", "--loss_impl", "fused", "--conv_impl", "fused", "--optimizer",
            optimizer, "--save_freq", "100", "--workdir", tempfile.mkdtemp(dir=workdir)]
    if config == "large_batch_a":
        argv.append("--syncBN")
    return argv + ARMS[arm]


def one_run(supcon, argv, config: str, trace_path=None) -> dict:
    """One driver run with its steps timed (or, with ``trace_path``, a
    profiler window of steps ``TRACE_FIRST`` to ``TRACE_FIRST +
    TRACE_STEPS - 1`` exported there)."""
    import torch

    step = supcon.train_step
    events, host_step, host_opt, prof = [], [], [], {}

    def timed(state, cfg, views, labels):
        k = len(events)
        if trace_path is not None and k == TRACE_FIRST:
            torch.cuda.synchronize()
            prof["open"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof["open"].__enter__()
        if "open" in prof and k == TRACE_FIRST + TRACE_STEPS:
            torch.cuda.synchronize()
            prof["done"] = prof.pop("open")
            prof["done"].__exit__(None, None, None)
        if k == 0:
            opt_step = state.optimizer.step

            def opt_timed(*args, **kwargs):
                t = time.perf_counter()
                out = opt_step(*args, **kwargs)
                host_opt.append(time.perf_counter() - t)
                return out
            state.optimizer.step = opt_timed
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        t0 = time.perf_counter()
        out = step(state, cfg, views, labels)
        host_step.append(time.perf_counter() - t0)
        return out

    env = {}
    if config == "large_batch_a":
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    supcon.train_step = timed
    try:
        result = supcon.main(argv)
    finally:
        supcon.train_step = step
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.synchronize()
    if trace_path is not None:
        prof["done"].export_chrome_trace(trace_path)
        return {"trace": trace_path}
    periods = [a.elapsed_time(b) for a, b in zip(events, events[1:])][TIMED]
    return {"period_ms": statistics.median(periods),
            "host_step_ms": statistics.median(host_step[TIMED]) * 1e3,
            "host_opt_ms": statistics.median(host_opt[TIMED]) * 1e3 if host_opt else None,
            "losses": [h["loss"] for h in result.history]}


def child(args) -> int:
    """Run ``args.arms`` x ``OPTIMIZERS`` in the checkout ``args.child``,
    one JSON line per run."""
    sys.path.insert(0, args.child)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from simclr_pytorch_distributed_tpu_torch.train import supcon

    workdir = tempfile.mkdtemp(prefix="flush_ab_")
    for optimizer in OPTIMIZERS:
        for arm in args.arms.split(","):
            trace = None
            if args.trace_dir:
                if optimizer != "lars":
                    continue
                trace = os.path.join(args.trace_dir, f"{args.label}_{arm}_lars.json")
            out = one_run(supcon, run_argv(args.model, optimizer, arm, args.config, workdir),
                          args.config, trace)
            print("RUN " + json.dumps({"tree": args.label, "optimizer": optimizer, "arm": arm,
                                       **out}), flush=True)
    return 0


def spawn(root: str, label: str, arms, args, trace_dir=None):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", root, "--label", label,
           "--arms", ",".join(arms), "--config", args.config, "--model", args.model]
    if trace_dir:
        cmd += ["--trace_dir", trace_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root, timeout=1800)
    runs = [json.loads(line[4:]) for line in proc.stdout.splitlines() if line.startswith("RUN ")]
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"the {label} child exited {proc.returncode}")
    for run in runs:
        print(json.dumps(run), flush=True)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIG_ARMS), default="plain")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", default=None, help="a parent checkout of the port")
    ap.add_argument("--also", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout of the port with the telemetry flags")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace_dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    ap.add_argument("--arms", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_flush_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        return child(args)
    print(f"nvidia-smi name, power.limit: {card_line()}", flush=True)
    trees = [(label, os.path.abspath(root), CONFIG_ARMS[args.config])
             for label, root in (spec.split("=", 1) for spec in args.also)]
    trees.append(("this", REPO, CONFIG_ARMS[args.config]))
    if args.parent:
        trees.insert(0, ("parent", os.path.abspath(args.parent), ("parent",)))
    runs = []
    for _ in range(args.rounds):
        for k, (label, root, arms) in enumerate(trees + trees[::-1]):
            runs += spawn(root, label, arms if k < len(trees) else arms[::-1], args)
    for label, _, arms in trees:
        for optimizer in OPTIMIZERS:
            for arm in arms:
                mine = [r for r in runs if (r["tree"], r["optimizer"], r["arm"]) ==
                        (label, optimizer, arm)]
                print(json.dumps({
                    "config": args.config, "model": args.model, "tree": label,
                    "optimizer": optimizer, "arm": arm, "flags": " ".join(ARMS[arm]),
                    **{key: [r.get(key) for r in mine] for key in
                       ("period_ms", "host_step_ms", "host_opt_ms")},
                    "median_period_ms": statistics.median(r["period_ms"] for r in mine)}),
                    flush=True)
    if args.trace:
        sys.path.insert(0, REPO)
        from chip_smoke import trace_summary

        trace_dir = tempfile.mkdtemp(prefix="flush_ab_traces_")
        for label, root, arms in trees:
            for run in spawn(root, label, arms, args, trace_dir=trace_dir):
                trace_summary(run["trace"], f"{label} {run['arm']} lars", TRACE_STEPS)
                os.remove(run["trace"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
