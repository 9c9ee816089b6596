"""Pretrain-and-probe accuracy of the PyTorch/CUDA port, with the JAX
package's ratchet recipe.

    python3 scripts/port_ratchet.py [--configs rn50_100ep rn18_100ep ...]

For each configuration, on one CUDA card and through the port's entry
points: ``train.supcon.main`` pretrains SimCLR on ``--dataset
synthetic_hard32`` with the argv of ``scripts/ratchet.py`` (batch 256, lr
0.1, ``--warm``, tau 0.5, ``--cosine``, seed 0; ``--bf16`` unless the
configuration says fp32; the default ``--conv_impl auto`` / ``--loss_impl
auto``, so the fused kernels on the card), then ``train.linear.main``
probes the run's ``last.pth`` (60 epochs, lr 5, batch 256, fp32). Prints
the card's name and power limit, then one JSON line per configuration:
the probe's best top-1 and top-5 beside the JAX package's bar
(``RATCHET_r05.json``), the final pretrain loss and both runs' wall
times. ``--epochs`` shortens the pretrain for a trial run (the bar then
means nothing). Exits non-zero without a card.

    python3 scripts/port_ratchet.py --configs ce_rn50_30ep

A ``ce_*`` configuration trains the supervised CE baseline instead
(``train.ce.main``) with the JAX ratchet's CE argv (``scripts/ratchet.py``
``ce_rn50_30ep``: ``--dataset synthetic_hard``, batch 256, lr 0.1,
``--cosine``, ``--bf16``, 30 epochs, seed 0) and records its best
validation top-1 against the JAX bar 98.2 (the JAX package measured 99.0,
``RATCHET_r05.json``); ``--epochs`` overrides its epochs too.

    python3 scripts/port_ratchet.py --configs invariant_lint

The ``invariant_lint`` gate (in the default list, as in the JAX ratchet,
``scripts/ratchet.py:207-218, 1379-1390``) runs
``scripts/port_invariant_lint.py --json`` over the port's tree (stdlib
``ast``, no device, so it binds on any machine and needs no card) and
judges the artifact with :func:`lint_gate_record`, the JAX gate's rules:
the pinned schema, all four rule families run, every allowlisted point
with a reason, and zero unallowlisted findings. A failed gate makes the
script exit 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (model, --bf16 pretrain, the JAX package's bar; scripts/ratchet.py
# CONFIGS, the JAX package measured 96.09 and 96.43 in RATCHET_r05.json)
CONFIGS = {
    "rn50_100ep": ("resnet50", True, 95.7),
    "rn18_100ep": ("resnet18", True, 95.4),
    "rn50_100ep_fp32": ("resnet50", False, 95.7),
}
# the CE baseline: name -> (model, epochs, the JAX package's bar; its
# measurement 99.0 in RATCHET_r05.json)
CE_CONFIGS = {
    "ce_rn50_30ep": ("resnet50", 30, 98.2),
}
# the static gates: name -> kind (no card, no driver)
GATE_CONFIGS = {
    "invariant_lint": dict(kind="invariant_lint"),
}
DEFAULT_CONFIGS = ["invariant_lint", "rn50_100ep", "rn18_100ep"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run_config(name: str, epochs: int, workdir: str, seed: int) -> dict:
    from simclr_pytorch_distributed_tpu_torch.train import linear, supcon

    model, bf16, bar = CONFIGS[name]
    t0 = time.time()
    pre = supcon.main([
        "--dataset", "synthetic_hard32", "--model", model, "--epochs", str(epochs),
        "--batch_size", "256", "--learning_rate", "0.1", "--warm", "--temp", "0.5",
        "--cosine", "--method", "SimCLR", "--save_freq", str(epochs), "--print_freq", "20",
        "--workdir", workdir, "--seed", str(seed), "--trial", name,
    ] + (["--bf16"] if bf16 else []))
    pretrain_s = time.time() - t0
    t1 = time.time()
    probe = linear.main([
        "--dataset", "synthetic_hard32", "--model", model, "--epochs", "60",
        "--learning_rate", "5", "--batch_size", "256", "--print_freq", "20",
        "--ckpt", os.path.join(pre.save_folder, "last.pth"), "--workdir", workdir,
        "--trial", name,
    ])
    return {
        "metric": f"port_ratchet_synthetic_hard32_probe_top1_{name}",
        "value": probe.best_acc, "top5": probe.best_acc5, "bar": bar,
        "ok": probe.best_acc >= bar, "model": model, "pretrain_bf16": bf16,
        "epochs": epochs, "seed": seed, "final_pretrain_loss": pre.history[-1]["loss"],
        "pretrain_s": pretrain_s, "probe_s": time.time() - t1,
        "pretrain_run": pre.save_folder, "probe_run": probe.save_folder,
    }


def run_ce_config(name: str, epochs: int, workdir: str, seed: int) -> dict:
    from simclr_pytorch_distributed_tpu_torch.train import ce

    model, default_epochs, bar = CE_CONFIGS[name]
    epochs = epochs or default_epochs
    t0 = time.time()
    result = ce.main([
        "--dataset", "synthetic_hard", "--model", model, "--epochs", str(epochs),
        "--batch_size", "256", "--learning_rate", "0.1", "--cosine", "--bf16",
        "--save_freq", str(epochs), "--print_freq", "20", "--workdir", workdir,
        "--seed", str(seed), "--trial", name,
    ])
    return {
        "metric": f"port_ratchet_synthetic_hard_ce_top1_{name}",
        "value": result.best_acc, "top5": result.best_acc5, "bar": bar,
        "ok": result.best_acc >= bar, "model": model, "bf16": True, "epochs": epochs,
        "seed": seed, "final_train_loss": result.history[-1]["loss"],
        "final_val_top1": result.val_history[-1]["top1"], "ce_s": time.time() - t0,
        "run": result.save_folder,
    }


def lint_gate_record(artifact: dict) -> dict:
    """Gate decision for one invariant_lint artifact (pure): the JAX
    ratchet's ``lint_gate_record`` on the port's runner. Binds on every
    machine: the claims are properties of the source tree. Checks the
    pinned schema, that all four rule families ran, that every allowlisted
    point carries a reason, and zero unallowlisted findings."""
    from simclr_pytorch_distributed_tpu_torch.analysis import runner as lint_runner

    record = {
        "metric": "port_ratchet_invariant_lint",
        "value": artifact.get("n_findings"),
        "files_scanned": artifact.get("files_scanned"),
        "rules_run": artifact.get("rules_run"),
        "allowlisted": [
            {"key": a.get("key"), "matched": len(a.get("findings", []))}
            for a in artifact.get("allowlisted", [])
        ],
    }

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if artifact.get("schema") != lint_runner.SCHEMA:
        return fail(f"unexpected schema {artifact.get('schema')!r}")
    missing = sorted(set(lint_runner.RULE_FAMILIES) - set(artifact.get("rules_run", [])))
    if missing:
        return fail(f"rule families did not run: {missing}")
    for entry in artifact.get("allowlisted", []):
        if not str(entry.get("reason", "")).strip():
            return fail(f"allowlist entry {entry.get('key')!r} carries no reason")
    findings = artifact.get("findings", [])
    if findings or not artifact.get("ok"):
        heads = "; ".join(f"{f.get('file')}:{f.get('line')} [{f.get('rule')}]"
                          for f in findings[:5])
        return fail(f"{len(findings)} unallowlisted invariant finding(s): {heads}")
    record["ok"] = True
    return record


def run_lint_gate(workdir: str) -> dict:
    """``scripts/port_invariant_lint.py --json`` in a child process, judged
    by :func:`lint_gate_record`. The linter exits 1 on findings and still
    writes its artifact, which the record then carries."""
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "port_invariant_lint.json")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "port_invariant_lint.py"),
         "--json", out], capture_output=True, text=True, timeout=600,
    )
    if not os.path.exists(out):
        return {"metric": "port_ratchet_invariant_lint", "ok": False,
                "error": f"the linter wrote no artifact (exit {proc.returncode}): "
                         f"{proc.stderr.strip()[-400:]}"}
    with open(out) as fh:
        return lint_gate_record(json.load(fh))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=DEFAULT_CONFIGS,
                    choices=sorted(CONFIGS) + sorted(CE_CONFIGS) + sorted(GATE_CONFIGS))
    ap.add_argument("--epochs", type=int, default=0,
                    help="pretrain epochs (default 100), or a CE configuration's epochs "
                         "(default its own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "work_space", "port_ratchet"))
    ap.add_argument("--json", default="", help="also append the records to this file")
    args = ap.parse_args(argv)
    gates_ok = True
    for name in [n for n in args.configs if n in GATE_CONFIGS]:
        record = run_lint_gate(args.workdir)
        gates_ok = gates_ok and record["ok"]
        print(json.dumps(record), flush=True)
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(json.dumps(record) + "\n")
    runs = [n for n in args.configs if n not in GATE_CONFIGS]
    if not runs:
        return 0 if gates_ok else 1
    if not torch.cuda.is_available():
        print("port_ratchet: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    for name in runs:
        if name in CE_CONFIGS:
            record = run_ce_config(name, args.epochs, args.workdir, args.seed)
        else:
            record = run_config(name, args.epochs or 100, args.workdir, args.seed)
        record["card"] = card
        root = logging.getLogger()
        for handler in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
            root.removeHandler(handler)  # each run's log-ing holds its own lines only
            handler.close()
        print(json.dumps(record), flush=True)
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(json.dumps(record) + "\n")
    return 0 if gates_ok else 1


if __name__ == "__main__":
    sys.exit(main())
