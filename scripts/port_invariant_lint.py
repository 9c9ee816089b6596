#!/usr/bin/env python
"""Static invariant linter for the PyTorch port's contracts.

Checks the port package (``simclr_pytorch_distributed_tpu_torch/``) and
the port's scripts (``scripts/port_*.py``) against four contracts, with
stdlib ``ast`` only (no torch, no jax; runs in about a second anywhere):

1. collective-schedule: no ``torch.distributed`` collective, port wrapper
   of one, ``SyncBatchNorm.apply``, preemption vote or boundary exchange
   under a process-dependent conditional, after a process-dependent early
   exit, or inside an exception-swallowing try;
2. donation-safety: no host use of a tensor that a ``non_blocking=True``
   copy may still be reading or writing, before a host wait;
3. hot-loop-sync: no host sync (``.item()``, ``.cpu()``, ``.tolist()``,
   ``.numpy()``, ``.synchronize()``, ``float``/``int``/``bool`` of a tensor,
   ``np.asarray``, a blocking ``torch.tensor(..., device=...)``) inside the
   flush-boundary loops, the step functions or the kernel wrappers, except
   at ``# sync-ok: <reason>`` annotated sites;
4. contract-registry: metric-key tuples sorted, unique and single-sourced,
   artifact schemas pinned to module constants, the trainers' shared flags
   agreeing through the port's ``config.py``.

Designed matched points live in the port's ``analysis/allowlist.py`` with
their reasons; a stale entry is a finding too. Exit 0 = clean.

Usage:
    python scripts/port_invariant_lint.py            # human-readable, exit 0/1
    python scripts/port_invariant_lint.py --json OUT # + the invariant_lint/v1
                                                     # artifact the ratchet gates on
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simclr_pytorch_distributed_tpu_torch.analysis import (  # noqa: E402
    build_output,
    run_lint,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="write the invariant_lint/v1 artifact here")
    ap.add_argument("--root", default=REPO,
                    help="repo root to lint (default: this checkout)")
    args = ap.parse_args(argv)

    result = run_lint(args.root)
    out = build_output(result)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)

    for f in result["findings"]:
        print(f.render())
    n_allow = sum(len(a["findings"]) for a in result["allowlisted"])
    print(
        f"port_invariant_lint: {len(result['findings'])} finding(s), "
        f"{n_allow} allowlisted matched point(s), "
        f"{result['files_scanned']} files scanned, "
        f"rules: {', '.join(result['rules_run'])}"
    )
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
