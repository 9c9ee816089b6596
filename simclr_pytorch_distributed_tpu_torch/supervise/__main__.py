"""CLI: ``python -m simclr_pytorch_distributed_tpu_torch.supervise [flags] -- cmd...``

Everything after ``--`` is the training command, launched as it is (plus an
appended ``--resume <run_dir>`` on relaunches). The port's launchers
(``simclr_pytorch_distributed_tpu_torch/run_supcon.sh``, ``run_linear.sh``)
hand their launch to it by default; ``SUPERVISE=0`` keeps their bounded
shell loop.

Example: babysit a two-process pretrain on the card with liveness-kill,
scraping the trainer's sidecar on 9100::

    python -m simclr_pytorch_distributed_tpu_torch.supervise \
        --workdir ./work_space --max_restarts 3 --stall_secs 300 \
        --metrics_port 9100 --devices 2 -- \
        python -m simclr_pytorch_distributed_tpu_torch.parallel.torchrun \
            --standalone -m simclr_pytorch_distributed_tpu_torch.train.supcon \
            --dataset cifar10 --metrics_port 9100 --watchdog_secs 120 ...

Exit code: 0 when the job completed; otherwise the final child's code
(signal deaths shell-normalized to 128+N), so CI and shell callers see
what a bash launcher would have reported.
"""

from __future__ import annotations

import argparse
import logging
import sys

from simclr_pytorch_distributed_tpu_torch.supervise.supervisor import (
    SuperviseConfig,
    Supervisor,
)

# Not imported from config.py: the supervisor's flags are its own, with the
# same bounds-checking convention as the trainers'.


def nonnegative_int_arg(name: str):
    def parse(s: str) -> int:
        try:
            v = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--{name} expects a non-negative integer, got {s!r}"
            ) from None
        if v < 0:
            raise argparse.ArgumentTypeError(
                f"--{name} must be >= 0, got {v}"
            )
        return v

    return parse


def positive_int_arg(name: str):
    def parse(s: str) -> int:
        v = nonnegative_int_arg(name)(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(
                f"--{name} must be positive, got {v}"
            )
        return v

    return parse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m simclr_pytorch_distributed_tpu_torch.supervise",
        description="elastic, self-healing training supervisor",
    )
    p.add_argument("--workdir", default="./work_space",
                   help="the trainer's --workdir: resume dirs are resolved "
                        "under <workdir>/*_models, supervisor events land "
                        "in <workdir>/supervise")
    p.add_argument("--max_restarts", type=nonnegative_int_arg("max_restarts"),
                   default=3,
                   help="total relaunch budget across ALL failure classes "
                        "(the launchers' PREEMPT_RETRIES contract)")
    p.add_argument("--backoff_base_s", type=float, default=1.0,
                   help="first-failure backoff; doubles per consecutive "
                        "failure (a clean preemption resets the streak)")
    p.add_argument("--backoff_max_s", type=float, default=60.0,
                   help="backoff cap")
    p.add_argument("--poll_secs", type=float, default=1.0,
                   help="channel polling cadence")
    p.add_argument("--stall_secs", type=float, default=0.0,
                   help="liveness deadline: kill + resume when the child's "
                        "train_last_boundary_age_seconds exceeds this or a "
                        "watchdog stall dump appears (0 = observe only). "
                        "Set well above the first-step compile AND the "
                        "trainer's own --watchdog_secs")
    p.add_argument("--straggler_skew_secs", type=float, default=1.0,
                   help="boundary-skew bar for the straggler finding "
                        "scraped off the child's "
                        "train_boundary_skew_seconds gauge (0 = off); "
                        "findings feed the K-of-N persistence detector")
    p.add_argument("--straggler_persist_k",
                   type=positive_int_arg("straggler_persist_k"), default=3,
                   help="boundaries (of the last --straggler_window_n) that "
                        "must name the SAME host above the bar before the "
                        "straggler is PERSISTENT (>= 2 gives hysteresis: a "
                        "one-boundary GC pause never triggers)")
    p.add_argument("--straggler_window_n",
                   type=positive_int_arg("straggler_window_n"), default=5,
                   help="sliding window of boundaries the K-of-N vote "
                        "runs over")
    p.add_argument("--straggler_mitigate", action="store_true",
                   default=False,
                   help="act on a persistence verdict: graceful preempt + "
                        "the escalation ladder restart_rebalanced -> "
                        "restart_resized (exclude) -> give_up, budget-"
                        "capped, never over a pending operator resize. "
                        "Default: record the verdict, take no action")
    p.add_argument("--grace_secs", type=float, default=20.0,
                   help="SIGTERM->SIGKILL window on a supervisor-initiated "
                        "kill (the preemption machinery's chance to save)")
    p.add_argument("--metrics_port", type=nonnegative_int_arg("metrics_port"),
                   default=0,
                   help="the CHILD's --metrics_port sidecar to scrape for "
                        "liveness (0 = no scraping; run-dir watchdog dumps "
                        "still count)")
    p.add_argument("--metrics_host", default="127.0.0.1")
    p.add_argument("--all_run_dirs", action="store_true", default=False,
                   help="include classifier_*/ce_* run dirs in run-dir "
                        "resolution — required when supervising the probe "
                        "or CE trainer, whose run dirs carry those "
                        "prefixes (the pretrain default excludes them)")
    p.add_argument("--devices", type=positive_int_arg("devices"), default=None,
                   help="manage the child's process count (torchrun's "
                        "PET_NPROC_PER_NODE); resize at runtime by "
                        "writing an integer to "
                        "<workdir>/supervise/resize_request. Default: "
                        "inherit the environment")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- followed by the training command")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        build_parser().error("no training command given (append: -- python -m "
                             "simclr_pytorch_distributed_tpu_torch.train.supcon ...)")
    logging.basicConfig(
        level=logging.INFO,
        format="[supervise] %(levelname)s %(message)s",
    )
    cfg = SuperviseConfig(
        command=command,
        workdir=args.workdir,
        max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base_s,
        backoff_max_s=args.backoff_max_s,
        poll_s=args.poll_secs,
        stall_secs=args.stall_secs,
        straggler_skew_secs=args.straggler_skew_secs,
        straggler_persist_k=args.straggler_persist_k,
        straggler_window_n=args.straggler_window_n,
        straggler_mitigate=args.straggler_mitigate,
        grace_secs=args.grace_secs,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        devices=args.devices or 0,
        all_run_dirs=args.all_run_dirs,
    )
    return Supervisor(cfg).run()


if __name__ == "__main__":
    sys.exit(main())
