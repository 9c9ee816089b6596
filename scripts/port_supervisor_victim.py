#!/usr/bin/env python
"""The port's pretraining trainer with one-shot faults: what the port's
supervisor babysits in its tests and in ``chip_smoke.py``'s ``supervise``
phase.

    python scripts/port_supervisor_victim.py [victim flags] [trainer flags]

Every flag the victim does not know goes to
``simclr_pytorch_distributed_tpu_torch.train.supcon`` as it is, so the
supervisor's appended ``--resume <run_dir>`` lands as on the real trainer,
and the run exits through the trainer's typed codes (``utils/guard.py``).
Each fault fires only while its marker file is absent and writes the marker
when it fires, so the supervisor's relaunch of the same command runs clean:

- ``--fault stall``: at the Nth flush-boundary preemption vote the main
  thread wedges and sleeps; a SIGTERM only sets the preemption flag, as a
  wedged collective would, so the supervisor's grace window lapses to
  SIGKILL. ``train_last_boundary_age_seconds`` climbs and the trainer's
  watchdog (``--watchdog_secs``) dumps its stacks;
- ``--fault nan``: the Nth finite-loss check raises ``NonFiniteLossError``:
  the trainer saves ``crash_epoch_E.pth`` and exits 1;
- ``--fault collapse``: impossible health bars (``eff_rank_min`` 1e9), so
  under ``--health_policy abort`` the first health window exits 3;
- ``--fault hold``: after the Nth train step the process prints ``HOLD``
  and waits for a signal: a SIGTERM sets the flag and the run preempts at
  the next boundary (exit 75); a SIGKILL lands mid-epoch;
- ``--straggler_ms`` (with its own ``--straggler_marker``): every flush
  boundary waits that long and then publishes the skew gauges a
  two-process fleet whose process 1 is that slow would publish (one
  process has no peers to wait on; the real two-process exchange is
  ``scripts/port_fleet_launcher.py``'s).

``--images N`` cuts the synthetic set to its first N images (the CPU
tests' size). Prints ``START wall=<s>`` on entry, ``SAVE_FOLDER <path>``,
``RUN wall=<s>`` (with the seconds torch's and torch._dynamo's imports
took) when the run is called, ``STEP_BEGIN wall=<s>`` when this process's
first step is called and ``FIRST_STEP wall=<s>`` when it has finished (the
wall clock, for the start-up's split), ``KERNELS <json>`` (the fused kernels this process
launched, at each epoch end and at the exit), and ``DONE step=<n>`` on a
completed run.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser("port supervisor victim")
    p.add_argument("--fault", default="none",
                   choices=["none", "stall", "nan", "collapse", "hold"])
    p.add_argument("--fault_step", type=int, default=3,
                   help="inject at the Nth call of the hooked check")
    p.add_argument("--fault_marker", default="",
                   help="one-shot gate: the fault fires only while this file is absent")
    p.add_argument("--straggler_ms", type=float, default=0.0,
                   help="pace every flush boundary by this much and publish a "
                        "two-process fleet's skew gauges naming process 1")
    p.add_argument("--straggler_marker", default="",
                   help="one-shot gate for --straggler_ms")
    p.add_argument("--images", type=int, default=0,
                   help="cut the synthetic set to its first N images (0 = all)")
    return p.parse_known_args(argv)


def kernel_launches():
    """The fused kernels' launch counters that are nonzero in this process."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv, fused_loss
    out = {f"loss_{k}": v for k, v in vars(fused_loss).items() if k.endswith("_launches")}
    out.update({k: v for k, v in vars(fused_conv).items() if k.endswith("_launches")})
    return {k: v for k, v in sorted(out.items()) if v}


def main(argv=None):
    start = time.time()
    print(f"START wall={start:.6f}", flush=True)
    args, trainer_argv = parse_args(argv)

    import torch
    torch_s = time.time() - start
    # torch.optim's first use imports torch._dynamo, seconds of a child's
    # start-up; taking it before the run keeps it out of the trainer's
    # watchdog window, so a stall scenario's deadline can stay short
    import torch._dynamo  # noqa: F401
    dynamo_s = time.time() - start - torch_s

    from simclr_pytorch_distributed_tpu_torch import config as config_lib
    from simclr_pytorch_distributed_tpu_torch.train import supcon
    from simclr_pytorch_distributed_tpu_torch.utils import guard, obs, preempt, telemetry

    def marked(path):
        return bool(path) and os.path.exists(path)

    def trip(path, what):
        if path:
            with open(path, "w") as f:
                f.write(what)

    if args.images:
        load = supcon.load_dataset

        def small(*a, **kw):
            train, test, n_cls = load(*a, **kw)
            return {k: v[:args.images] for k, v in train.items()}, test, n_cls

        supcon.load_dataset = small

    armed = args.fault != "none" and not marked(args.fault_marker)
    steps = {"n": 0}
    step = supcon.train_step

    def watched_step(state, cfg, views, labels):
        if steps["n"] == 0:
            print(f"STEP_BEGIN wall={time.time():.6f}", flush=True)
        metrics = step(state, cfg, views, labels)
        steps["n"] += 1
        if steps["n"] == 1:
            if views.is_cuda:
                torch.cuda.synchronize(views.device)
            print(f"FIRST_STEP wall={time.time():.6f}", flush=True)
        if armed and args.fault == "hold" and steps["n"] == args.fault_step:
            trip(args.fault_marker, "hold")
            print(f"HOLD step={steps['n']} pid={os.getpid()}", flush=True)
            deadline = time.time() + 300
            while not preempt.requested():
                if time.time() > deadline:
                    raise RuntimeError("HOLD: no signal came")
                time.sleep(0.01)
        return metrics

    supcon.train_step = watched_step

    epoch_fn = supcon.train_one_epoch

    def reporting_epoch(*a, **kw):
        try:
            return epoch_fn(*a, **kw)
        finally:
            print(f"KERNELS {json.dumps(kernel_launches())}", flush=True)

    supcon.train_one_epoch = reporting_epoch

    if armed and args.fault == "stall":
        votes = {"n": 0}
        vote = preempt.requested_global

        def stalling_vote():
            votes["n"] += 1
            if votes["n"] == args.fault_step:
                trip(args.fault_marker, "stall")
                print(f"FAULT stall: main thread wedged pid={os.getpid()}", flush=True)
                while True:  # a signal only sets the flag, as in a wedged collective
                    time.sleep(3600)
            return vote()

        preempt.requested_global = stalling_vote
    elif armed and args.fault == "nan":
        checks = {"n": 0}
        check = supcon.check_finite_loss

        def poisoned_check(loss, step, enabled=True):
            checks["n"] += 1
            if checks["n"] == args.fault_step:
                trip(args.fault_marker, "nan")
                print("FAULT nan: poisoning the loss check", flush=True)
                raise guard.NonFiniteLossError(float("nan"), step)
            return check(loss, step, enabled)

        supcon.check_finite_loss = poisoned_check
    elif armed and args.fault == "collapse":
        obs.thresholds_for_recipe = lambda recipe: guard.HealthThresholds(eff_rank_min=1e9)
        trip(args.fault_marker, "collapse")
        print("FAULT collapse: impossible health thresholds", flush=True)

    if args.straggler_ms > 0 and not marked(args.straggler_marker):
        exchange = telemetry.TelemetrySession.check_failures_global
        skew_s = args.straggler_ms / 1e3

        def skewed_exchange(self, step_hint=0):
            if not marked(args.straggler_marker):
                trip(args.straggler_marker, f"straggler {args.straggler_ms}ms")
                print("FAULT straggler: boundary skew armed", flush=True)
            time.sleep(skew_s)
            exchange(self, step_hint)
            if self._gauges is not None:
                # what a two-process fleet whose process 1 is this slow publishes
                self._gauges.set(boundary_skew_seconds=skew_s, boundary_straggler=1.0,
                                 process_count=2.0)

        telemetry.TelemetrySession.check_failures_global = skewed_exchange

    cfg = config_lib.parse_supcon(trainer_argv)
    print(f"SAVE_FOLDER {cfg.save_folder}", flush=True)
    print(f"RUN wall={time.time():.6f} import_torch_s={torch_s:.3f} "
          f"import_dynamo_s={dynamo_s:.3f}", flush=True)

    def run():
        try:
            result = supcon.run(cfg)
        finally:
            print(f"KERNELS {json.dumps(kernel_launches())}", flush=True)
        print(f"DONE step={result.state.step}", flush=True)

    guard.exit_with_code(run)


if __name__ == "__main__":
    main()
