#!/usr/bin/env python
"""The SSL recipes' evidence for the port (the port's copy of JAX
``scripts/recipes_eval.py``; the ``recipes`` gate of
``scripts/port_ratchet.py`` judges its artifact).

Two claims, both through the port's pretraining driver
(``train.supcon.main``):

1. **Bit-identity**: ``--recipe supcon`` through the recipe interface
   gives bitwise the parameters, BN buffers and momentum of the inline
   step (``TrainState.recipe = None``, the step's own contrastive path)
   over more than one epoch, under ``--data_placement host`` and
   ``device``. The inline arm takes the recipe off the state after the
   driver attaches it; everything else (the ring's columns, the slots,
   the checkpoints) is the same by the slot-free recipe's contract.
2. **Each recipe learns**: supcon, byol, simsiam, vicreg and simclr with
   ``--moco_queue 256`` each train with the online probe and the health
   stream on; the best windowed probe top-1 and the alarms are read back
   from the run's own ``events.jsonl`` through the health report
   (``utils/health_report.py``), not from the driver's state.

    python3 scripts/port_recipes_eval.py [--device cuda|cpu] [--json out.json]
    python3 scripts/port_recipes_eval.py --smoke --device cpu --json out.json

The full configuration: rn10, ``--dataset synthetic``, batch 64, 16 px, two
epochs, lr 0.05 cosine, temperature 0.5, ``--predictor_hidden 128``,
``--print_freq 5``, ``--telemetry sync``; the probe arms add ``--online_probe
on --health_freq 2 --health_policy warn``. ``--smoke`` is one epoch at 8
px. Prints one JSON line per claim and arm; exits 0 when the bit-identity
holds and every arm's health stream is consistent with no alarm, else 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SCHEMA = "recipes_eval/v1"
BATCH_SIZE = 64
MODEL = "resnet10"

# the probe arms: (arm name, extra arguments); simclr_queue is the MoCo
# queue on the simclr recipe, which must not break learning
PROBE_ARMS = (
    ("supcon", ["--recipe", "supcon"]),
    ("byol", ["--recipe", "byol"]),
    ("simsiam", ["--recipe", "simsiam"]),
    ("vicreg", ["--recipe", "vicreg"]),
    ("simclr_queue", ["--recipe", "simclr", "--moco_queue", "256"]),
)
PLACEMENTS = ("host", "device")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default="", help="write the artifact here")
    ap.add_argument("--smoke", action="store_true",
                    help="the gate's small configuration (8 px, one epoch)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="pretrain epochs of each run (default 2; smoke 1)")
    ap.add_argument("--size", type=int, default=None, help="image side (default 16; smoke 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trial", default="recipes_eval")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workdir", default=os.path.join(REPO, "work_space", "port_recipes_eval"))
    args = ap.parse_args(argv)
    if args.epochs is None:
        args.epochs = 1 if args.smoke else 2
    if args.size is None:
        args.size = 8 if args.smoke else 16
    return args


def run_argv(args, trial, extra):
    """The driver's argv of one run of this evaluation."""
    return [
        "--device", args.device, "--dataset", "synthetic", "--model", MODEL,
        "--batch_size", str(BATCH_SIZE), "--learning_rate", "0.05", "--cosine",
        "--temp", "0.5", "--method", "SimCLR", "--epochs", str(args.epochs),
        "--save_freq", str(max(1, args.epochs)), "--print_freq", "5", "--size", str(args.size),
        "--seed", str(args.seed), "--workdir", args.workdir, "--trial", trial,
        "--telemetry", "sync", "--flight_recorder", "on", "--predictor_hidden", "128",
    ] + list(extra)


def _run(argv):
    from simclr_pytorch_distributed_tpu_torch.train import supcon

    result = supcon.main(argv)
    # each run's log-ing holds its own lines only
    root = logging.getLogger()
    for handler in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
        root.removeHandler(handler)
        handler.close()
    return result


def _state_tensors(state):
    """What the bit-identity compares: the model's parameters and BN buffers
    and the optimizer's momentum buffers."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, entry in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in entry.items()})
    return out


def bit_identity_check(args):
    """``--recipe supcon --method SupCon`` through the interface against the
    inline step, per data placement: ``{'epochs', 'steps', 'placements':
    {placement: bitwise equal}, 'ok'}``."""
    import torch
    from simclr_pytorch_distributed_tpu_torch.train import supcon

    attach = supcon.attach_for_config

    def inline(cfg, state):
        state, recipe = attach(cfg, state)
        state.recipe = None  # the step's own contrastive path
        return state, recipe

    record = {"epochs": args.epochs, "placements": {}}
    for placement in PLACEMENTS:
        states = {}
        for arm in ("recipe", "inline"):
            extra = ["--recipe", "supcon", "--method", "SupCon", "--data_placement", placement]
            supcon.attach_for_config = inline if arm == "inline" else attach
            try:
                states[arm] = _run(run_argv(args, f"{args.trial}_bit_{placement}_{arm}",
                                            extra)).state
            finally:
                supcon.attach_for_config = attach
        a, b = _state_tensors(states["recipe"]), _state_tensors(states["inline"])
        record["placements"][placement] = a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) for k in a)
        record["steps"] = int(states["recipe"].step)
    record["ok"] = all(record["placements"].values())
    return record


def probe_arm(args, name, extra):
    """One recipe's run with the online probe and the health stream on; its
    figures read back from the run's ``events.jsonl`` through the health
    report."""
    from simclr_pytorch_distributed_tpu_torch.utils import health_report

    result = _run(run_argv(args, f"{args.trial}_{name}", list(extra) + [
        "--online_probe", "on", "--health_freq", "2", "--health_policy", "warn"]))
    rep = health_report.build_report(
        health_report.load_events(os.path.join(result.save_folder, "events.jsonl")))
    probe = rep["probe"] or {}
    queue = extra[extra.index("--moco_queue") + 1] if "--moco_queue" in extra else 0
    return {
        "recipe": extra[extra.index("--recipe") + 1],
        "moco_queue": int(queue),
        "probe_best_top1": probe.get("best_top1"),
        "probe_first_top1": probe.get("first_top1"),
        "probe_last_top1": probe.get("last_top1"),
        "windows": probe.get("windows"),
        "alarms": len(rep["alarms"]),
        "consistency_ok": rep["consistency"]["ok"],
        "thresholds": rep["thresholds"],
        "run": result.save_folder,
    }


def build_output(device, smoke, config, bit_identity, recipes):
    """The artifact (pure): JAX ``recipes_eval``'s schema."""
    return {"schema": SCHEMA, "device": device, "smoke": bool(smoke), "config": config,
            "bit_identity": bit_identity, "recipes": recipes}


def config_of(args):
    return {"epochs": args.epochs, "size": args.size, "seed": args.seed,
            "batch_size": BATCH_SIZE, "model": MODEL}


def artifact_ok(artifact) -> bool:
    """The script's own verdict: the bit-identity holds, and every arm's
    stream is consistent with no alarm."""
    return bool(artifact["bit_identity"]["ok"]) and all(
        r["consistency_ok"] and not r["alarms"] for r in artifact["recipes"].values())


def main(argv=None) -> int:
    args = parse_args(argv)
    bit = bit_identity_check(args)
    print(json.dumps({"bit_identity": bit}), flush=True)
    recipes = {}
    for name, extra in PROBE_ARMS:
        recipes[name] = probe_arm(args, name, extra)
        print(json.dumps({name: recipes[name]}), flush=True)
    out = build_output(args.device, args.smoke, config_of(args), bit, recipes)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0 if artifact_ok(out) else 1


if __name__ == "__main__":
    sys.exit(main())
