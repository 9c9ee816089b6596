"""Pretrain-and-probe accuracy of the PyTorch/CUDA port, with the JAX
package's ratchet recipe.

    python3 scripts/port_ratchet.py [--configs rn50_100ep rn18_100ep ...]

For each configuration, on one CUDA card and through the port's entry
points: ``train.supcon.main`` pretrains (SimCLR, or the configuration's
method) on ``--dataset synthetic_hard32`` with the argv of
``scripts/ratchet.py`` (batch 256, lr
0.1, ``--warm``, tau 0.5, ``--cosine``, seed 0; ``--bf16`` unless the
configuration says fp32; the default ``--conv_impl auto`` / ``--loss_impl
auto``, so the fused kernels on the card), then ``train.linear.main``
probes the run's ``last.pth`` (60 epochs, lr 5, batch 256, fp32). Prints
the card's name and power limit, then one JSON line per configuration:
the probe's best top-1 and top-5 beside the JAX package's bar
(``RATCHET_r05.json``), the final pretrain loss and both runs' wall
times. ``--epochs`` shortens the pretrain for a trial run (the bar then
means nothing). Exits non-zero without a card.

``supcon_rn50_50ep`` (``--method SupCon``, 50 epochs, bar 90.0) and
``rn50_200ep`` (200 epochs, bar 98.8) are the JAX ratchet's other two
accuracy configurations, with its argv and bars; each record carries the
pretrain's loss curve (the mean loss of each epoch) and the fused kernels
it launched. The JAX package's SupCon bar holds at its seed 0 only (a
seed-metastable configuration): a miss is recorded as it reads.

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

    python3 scripts/port_ratchet.py --configs supervisor_gate chaos_matrix serve_fleet \
        fleet_report

The four artifact gates (in the default list, as in the JAX ratchet,
``scripts/ratchet.py:157, 181, 232, 248``) judge the committed port
artifacts ``docs/evidence/port_*_r21.json`` (made on the card by
``scripts/port_supervisor_matrix.py`` and
``scripts/port_serve_fleet_scenario.py``) by port copies of the JAX
records (:func:`supervisor_gate_record`, :func:`chaos_gate_record`,
:func:`serve_fleet_gate_record`, :func:`fleet_gate_record`): the same
rules and expected decision tables. They need no card; a missing artifact
fails its gate.

    python3 scripts/port_ratchet.py --configs health_report recipes [--device cpu]

The ``health_report`` and ``recipes`` gates (in the default list, as in
the JAX ratchet, ``scripts/ratchet.py:144, 173, 1265-1348``) run the
port's trainer on ``--device`` (default the card): ``health_report`` one
rn10 epoch at batch 64 with ``--health_freq 2 --online_probe on``, then
``scripts/port_health_report.py`` over its ``events.jsonl``;
``recipes`` ``scripts/port_recipes_eval.py --smoke``. Their records
(:func:`health_report_gate_record`, :func:`recipe_gate_record`) are the
JAX gates' rules: the health stream's consistency, zero ``health_alarm``
events and, for ``recipes``, the supcon bit-identity under host and device
placement bind on every device; the online-probe bars
(:data:`HEALTH_PROBE_CPU_BAR`, :data:`RECIPE_PROBE_CPU_BARS`, calibrated by
the JAX package on the CPU) bind on the CPU only and pass-skip on the card
with the reason on the record.
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

# name -> the pretrain (model, --bf16, --method, epochs) and the JAX
# package's bar (scripts/ratchet.py CONFIGS; the JAX package measured 96.09
# and 96.43 for the 100-epoch pair in RATCHET_r05.json). supcon_rn50_50ep is
# seed-metastable in the JAX package (its bar, 92.52 measured minus 2.5, holds
# at seed 0 only; seeds 1 and 2 landed at 48 and 71 there): a miss is
# recorded, never rerun at another seed, length or bar
CONFIGS = {
    "rn50_100ep": dict(model="resnet50", bf16=True, method="SimCLR", epochs=100, bar=95.7),
    "rn18_100ep": dict(model="resnet18", bf16=True, method="SimCLR", epochs=100, bar=95.4),
    "rn50_100ep_fp32": dict(model="resnet50", bf16=False, method="SimCLR", epochs=100,
                            bar=95.7),
    "rn50_200ep": dict(model="resnet50", bf16=True, method="SimCLR", epochs=200, bar=98.8),
    "supcon_rn50_50ep": dict(model="resnet50", bf16=True, method="SupCon", epochs=50,
                             bar=90.0),
}
# the CE baseline: name -> (model, epochs, the JAX package's bar; its
# measurement 99.0 in RATCHET_r05.json)
CE_CONFIGS = {
    "ce_rn50_30ep": ("resnet50", 30, 98.2),
}
# the gates: name -> its kind, and whether it runs the trainer on --device
# (the lint gate reads the source tree only; an artifact gate judges a
# committed evidence file, made on the card by the named script)
GATE_CONFIGS = {
    "invariant_lint": dict(kind="invariant_lint", driver=False),
    "health_report": dict(kind="health_report", driver=True),
    "recipes": dict(kind="recipes", driver=True),
    # scripts/port_supervisor_matrix.py --json: sigkill, stall, collapse and
    # preempt_resize against the port's trainer (JAX scripts/ratchet.py:157)
    "supervisor_gate": dict(kind="supervisor_gate", driver=False,
                            artifact="docs/evidence/port_supervisor_r21.json"),
    # scripts/port_supervisor_matrix.py --chaos_json: the straggler ladder
    # and the composed chaos run (JAX :232)
    "chaos_matrix": dict(kind="chaos_gate", driver=False,
                         artifact="docs/evidence/port_chaos_matrix_r21.json"),
    # scripts/port_serve_fleet_scenario.py: the supervised replica fleet
    # (JAX :248)
    "serve_fleet": dict(kind="serve_fleet_gate", driver=False,
                        artifact="docs/evidence/port_serve_fleet_r21.json"),
    # scripts/port_supervisor_matrix.py --fleet_json: the merge of a real
    # two-process run by scripts/port_trace_report.py --fleet (JAX :181)
    "fleet_report": dict(kind="fleet_report", driver=False,
                         artifact="docs/evidence/port_fleet_report_r21.json"),
}
DEFAULT_CONFIGS = ["invariant_lint", "health_report", "recipes", "supervisor_gate",
                   "chaos_matrix", "serve_fleet", "fleet_report", "rn50_100ep", "rn18_100ep"]

# The JAX ratchet's CPU-calibrated probe bars (scripts/ratchet.py:269-292):
# the best windowed online-probe top-1 of the health_report smoke (chance 10%
# on the 10-class synthetic set; the JAX package measured 35.5 at one epoch)
# and of each recipes_eval --smoke arm (it measured 46.8-47.1). Beat-random
# with a wide margin: the claim is that the live probe learns.
HEALTH_PROBE_CPU_BAR = 20.0
RECIPE_PROBE_CPU_BARS = {
    "supcon": 20.0,
    "byol": 20.0,
    "simsiam": 20.0,
    "vicreg": 20.0,
    "simclr_queue": 20.0,
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pretrain_argv(name: str, epochs: int, workdir: str, seed: int) -> list:
    """The pretrain's argv of configuration ``name``: the JAX ratchet's
    (``scripts/ratchet.py:1505-1514``) on the port's entry point."""
    spec = CONFIGS[name]
    return [
        "--dataset", "synthetic_hard32", "--model", spec["model"], "--epochs", str(epochs),
        "--batch_size", "256", "--learning_rate", "0.1", "--warm", "--temp", "0.5",
        "--cosine", "--method", spec["method"], "--save_freq", str(epochs),
        "--print_freq", "20", "--workdir", workdir, "--seed", str(seed), "--trial", name,
    ] + (["--bf16"] if spec["bf16"] else [])


def epoch_means(history: list) -> list:
    """The mean training loss of each epoch of a run's ``history`` (one
    entry a step): the run's loss curve."""
    by_epoch = {}
    for h in history:
        by_epoch.setdefault(h["epoch"], []).append(h["loss"])
    return [round(sum(v) / len(v), 6) for _, v in sorted(by_epoch.items())]


def launch_counters() -> list:
    """``(module, name)`` of every fused kernel's launch counter."""
    from simclr_pytorch_distributed_tpu_torch.ops import fused_conv, fused_loss
    return [(mod, k) for mod in (fused_loss, fused_conv) for k in sorted(vars(mod))
            if k.endswith("_launches")]


def run_config(name: str, epochs: int, workdir: str, seed: int) -> dict:
    from simclr_pytorch_distributed_tpu_torch.ops import fused_loss
    from simclr_pytorch_distributed_tpu_torch.train import linear, supcon

    spec = CONFIGS[name]
    model, bf16, bar = spec["model"], spec["bf16"], spec["bar"]
    epochs = epochs or spec["epochs"]
    counters = launch_counters()
    for mod, counter in counters:
        setattr(mod, counter, 0)
    t0 = time.time()
    pre = supcon.main(pretrain_argv(name, epochs, workdir, seed))
    launches = {("loss_" if mod is fused_loss else "") + counter: getattr(mod, counter)
                for mod, counter in counters if getattr(mod, counter)}
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
        "ok": probe.best_acc >= bar, "model": model, "method": spec["method"],
        "pretrain_bf16": bf16, "epochs": epochs, "seed": seed,
        "final_pretrain_loss": pre.history[-1]["loss"],
        "pretrain_loss_by_epoch": epoch_means(pre.history),
        "pretrain_steps": len(pre.history), "kernel_launches": launches,
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


def health_report_gate_record(artifact: dict, probe_bar: float = None) -> dict:
    """Gate decision for one health-report artifact (pure; JAX
    ``scripts/ratchet.py:516``). Binds on every device: the stream's
    consistency (non-empty, monotone, the full column set in every window)
    and zero ``health_alarm`` events, since the detector firing on the
    healthy smoke is the false positive that would abort real runs under
    ``--health_policy abort``. The probe's best windowed top-1 over
    ``probe_bar`` binds on the CPU only, where the bar was calibrated; on
    the card it pass-skips with the reason on the record."""
    if probe_bar is None:
        probe_bar = HEALTH_PROBE_CPU_BAR
    rep = artifact["report"]
    cons = rep["consistency"]
    probe = rep.get("probe") or {}
    record = {
        "metric": "port_ratchet_health_report",
        "value": probe.get("best_top1"),
        "bar": probe_bar,
        "n_windows": cons["n_windows"],
        "alarms": len(rep["alarms"]),
        "findings": [f["flag"] for f in rep["findings"]],
        "device": artifact.get("device"),
    }

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if not cons["ok"]:
        return fail("health stream inconsistent: empty/non-monotone timeline or missing "
                    f"columns {cons['missing_keys']}")
    if rep["alarms"]:
        return fail(f"collapse detector fired {len(rep['alarms'])}x on the healthy smoke "
                    "(false positive)")
    if not probe:
        return fail("no online-probe columns in the health stream")
    if artifact.get("device") != "cpu":
        record["ok"] = True
        record["skipped"] = (f"device {artifact.get('device')!r}: probe-accuracy bar "
                             "calibrated for the CPU smoke only; stream consistency and "
                             "zero-alarm checks still enforced")
        return record
    if probe["best_top1"] < probe_bar:
        return fail(f"online probe best top-1 {probe['best_top1']:.2f} < {probe_bar:g}: the "
                    "live probe did not learn")
    record["ok"] = True
    return record


def recipe_gate_record(artifact: dict, bars: dict = None) -> dict:
    """Gate decision for one ``port_recipes_eval.py`` artifact (pure; JAX
    ``scripts/ratchet.py:580``). Binds on every device: the supcon
    bit-identity under host and device placement, a consistent health
    stream and zero collapse alarms per arm, and every arm present with
    probe columns. The per-arm probe bars bind on the CPU only; on the card
    they pass-skip with the reason on the record."""
    if bars is None:
        bars = RECIPE_PROBE_CPU_BARS
    bit = artifact.get("bit_identity", {})
    recipes = artifact.get("recipes", {})
    record = {
        "metric": "port_ratchet_recipes",
        "value": {name: (rec or {}).get("probe_best_top1") for name, rec in recipes.items()},
        "bars": bars,
        "bit_identity": bit.get("placements"),
        "alarms": {n: (r or {}).get("alarms") for n, r in recipes.items()},
        "device": artifact.get("device"),
    }

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if not bit.get("ok") or set(bit.get("placements", {})) != {"host", "device"}:
        return fail(f"supcon bit-identity failed or incomplete: {bit.get('placements')}")
    missing = sorted(set(bars) - set(recipes))
    if missing:
        return fail(f"recipe arms missing from the artifact: {missing}")
    for name in sorted(bars):
        rec = recipes[name] or {}
        if not rec.get("consistency_ok"):
            return fail(f"recipe {name!r}: inconsistent health stream")
        if rec.get("alarms"):
            return fail(f"recipe {name!r}: collapse detector fired {rec['alarms']}x on the "
                        "healthy run (false positive)")
        if rec.get("probe_best_top1") is None:
            return fail(f"recipe {name!r}: no online-probe columns")
    if artifact.get("device") != "cpu":
        record["ok"] = True
        record["skipped"] = (f"device {artifact.get('device')!r}: probe bars calibrated for "
                             "the CPU smoke only; bit-identity and zero-alarm checks still "
                             "enforced")
        return record
    for name, bar in sorted(bars.items()):
        best = recipes[name]["probe_best_top1"]
        if best < bar:
            return fail(f"recipe {name!r}: online probe best top-1 {best:.2f} < {bar:g}: the "
                        "recipe did not learn")
    record["ok"] = True
    return record


# the failure shapes the supervisor matrix must prove, with the decision
# sequence each must have produced (JAX scripts/ratchet.py:658)
SUPERVISOR_SCENARIOS = {
    "sigkill": ["backoff_restart", "done"],
    "stall": ["backoff_restart", "done"],
    "collapse": ["give_up"],
    "preempt_resize": ["restart_resized", "done"],
}
# the straggler-mitigation scenarios (JAX scripts/ratchet.py:724)
CHAOS_SCENARIOS = {
    "straggler": ["restart_rebalanced", "done"],
    "chaos": ["restart_rebalanced", "backoff_restart", "done"],
}


def supervisor_gate_record(artifact: dict) -> dict:
    """Gate decision for the supervisor scenario-matrix evidence (pure; the
    JAX ratchet's ``supervisor_gate_record``, ``scripts/ratchet.py:666``).
    Binds on every device: decision sequences and recorded events, not
    timings. Every scenario of :data:`SUPERVISOR_SCENARIOS` present and ok
    with exactly its decisions; the collapse leg exited 3 after an observed
    ``health_alarm``; the stall leg saw a liveness verdict and the
    watchdog's dump; the resize leg resumed onto another process count."""
    scenarios = artifact.get("scenarios", {})
    record = {"metric": "ratchet_supervisor_matrix", "value": len(scenarios),
              "scenarios": sorted(scenarios)}

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    for name, expected in SUPERVISOR_SCENARIOS.items():
        rec = scenarios.get(name)
        if rec is None:
            return fail(f"scenario {name!r} missing from the matrix artifact")
        if not rec.get("ok"):
            return fail(f"scenario {name!r} not ok in the matrix artifact")
        if rec.get("decisions") != expected:
            return fail(f"scenario {name!r} decisions {rec.get('decisions')} != "
                        f"expected {expected}")
    if scenarios["collapse"].get("rc") != 3:
        return fail("collapse scenario did not exit with the typed health code 3")
    if not scenarios["collapse"].get("health_alarms_observed"):
        return fail("collapse scenario recorded no observed health_alarm")
    if not (scenarios["stall"].get("liveness_stalls")
            and scenarios["stall"].get("watchdog_dumps_observed")):
        return fail("stall scenario lacks liveness/watchdog evidence")
    resize = scenarios["preempt_resize"]
    if not resize.get("resumed_resized"):
        return fail("resize scenario did not resume onto a new topology")
    devices = resize.get("launch_devices") or []
    if len(set(d for d in devices if d)) < 2:
        return fail(f"resize scenario launch_devices {devices} never changed")
    record["ok"] = True
    return record


def chaos_gate_record(artifact: dict) -> dict:
    """Gate decision for the straggler-mitigation and composed-chaos
    evidence (pure; JAX ``chaos_gate_record``, ``scripts/ratchet.py:730``).
    Both scenarios of :data:`CHAOS_SCENARIOS` present, ok, with exactly
    their decisions, exit 0 and both mitigation phases; the straggler leg's
    findings, persistence verdict, the share hint carried into a relaunch
    and digests equal to the policy-off control; the chaos leg's SIGKILLed
    pid and observed health alarms."""
    scenarios = artifact.get("scenarios", {})
    record = {"metric": "ratchet_chaos_matrix", "value": len(scenarios),
              "scenarios": sorted(scenarios)}

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if artifact.get("schema") != "chaos_matrix/v1":
        return fail(f"unexpected schema {artifact.get('schema')!r}")
    for name, expected in CHAOS_SCENARIOS.items():
        rec = scenarios.get(name)
        if rec is None:
            return fail(f"scenario {name!r} missing from the chaos artifact")
        if not rec.get("ok"):
            return fail(f"scenario {name!r} not ok in the chaos artifact")
        if rec.get("decisions") != expected:
            return fail(f"scenario {name!r} decisions {rec.get('decisions')} != "
                        f"expected {expected}")
        if rec.get("rc") != 0:
            return fail(f"scenario {name!r} did not land green (rc {rec.get('rc')})")
        if rec.get("mitigation_events", 0) < 2:
            return fail(f"scenario {name!r} lacks both mitigation phases (preempt + decided)")
    strag = scenarios["straggler"]
    if not (strag.get("straggler_findings") and strag.get("persistence_verdicts")):
        return fail("straggler scenario lacks finding/persistence evidence")
    hint = strag.get("share_hint_carried")
    if not (hint and hint in (strag.get("launch_shares") or [])):
        return fail("straggler scenario never carried the rebalance share hint into a "
                    "relaunch")
    if not strag.get("bit_identical"):
        return fail(f"mitigated digests {strag.get('digests')} != policy-off control "
                    f"{strag.get('control_digests')}")
    chaos = scenarios["chaos"]
    if not chaos.get("killed_pid"):
        return fail("chaos scenario recorded no SIGKILLed pid")
    if not chaos.get("health_alarms_observed"):
        return fail("chaos scenario recorded no observed health_alarm")
    record["ok"] = True
    return record


def serve_fleet_gate_record(artifact: dict) -> dict:
    """Gate decision for the serve-fleet scenario evidence (pure; JAX
    ``serve_fleet_gate_record``, ``scripts/ratchet.py:798``): the fleet
    raised to its 2-replica floor with ``/embed`` from both; a SIGKILLed
    replica's ``restart_replica`` on the same port (old return code -9)
    serving again; the promote under live load with zero failed requests,
    the old version retired and version 2 installed; the served image its
    own ``/neighbors`` top-1 at cosine >= 0.999; no replica given up."""
    phases = artifact.get("phases", {})
    record = {"metric": "ratchet_serve_fleet", "value": len(phases), "phases": sorted(phases)}

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if artifact.get("schema") != "serve_fleet/v1":
        return fail(f"unexpected schema {artifact.get('schema')!r}")
    for name in ("spawn", "restart", "promote", "neighbors"):
        rec = phases.get(name)
        if rec is None:
            return fail(f"phase {name!r} missing from the fleet artifact")
        if not rec.get("ok"):
            return fail(f"phase {name!r} not ok in the fleet artifact")
    spawn = phases["spawn"]
    if len(spawn.get("replicas", {})) < 2:
        return fail("spawn phase never reached the 2-replica floor")
    if len(spawn.get("warm_embed", {})) < 2:
        return fail("spawn phase lacks /embed proof from both replicas")
    restart = phases["restart"]
    restarts = [d for d in restart.get("decisions", []) if d.get("action") == "restart_replica"]
    if not restarts:
        return fail("restart phase recorded no restart_replica decision")
    if restarts[0].get("port") != restart.get("port"):
        return fail("restart did not relaunch on the same port")
    if restarts[0].get("old_returncode") != -9:
        return fail(f"restarted replica's returncode {restarts[0].get('old_returncode')} "
                    "is not SIGKILL")
    if not restart.get("served_after_restart"):
        return fail("restarted replica never served again")
    promote = phases["promote"]
    if promote.get("embed_failures"):
        return fail(f"hot-swap dropped requests: {promote['embed_failures']}")
    if promote.get("embed_ok", 0) < 10:
        return fail("promote phase had no meaningful live load")
    if not promote.get("drained"):
        return fail("old version never drained to 'retired'")
    if promote.get("response", {}).get("version") != 2:
        return fail("promote did not install version 2")
    neighbors = phases["neighbors"]
    if not neighbors.get("self_top1"):
        return fail("served image is not its own /neighbors top-1")
    if neighbors.get("top1_score", 0.0) < 0.999:
        return fail(f"self-neighbor cosine {neighbors.get('top1_score')} below identity")
    if artifact.get("gave_up"):
        return fail(f"supervisor gave up on replicas {artifact['gave_up']}")
    record["ok"] = True
    return record


def fleet_gate_record(artifact: dict) -> dict:
    """Gate decision for the fleet-merge evidence (pure; JAX
    ``fleet_gate_record``, ``scripts/ratchet.py:940``): every session
    merged consistently (anchor residuals under tolerance, whole collective
    boundaries, per-process attribution), and at least one session merges
    two processes or more."""
    sessions = artifact.get("sessions", {})
    record = {"metric": "ratchet_fleet_report", "value": len(sessions),
              "sessions": sorted(sessions)}

    def fail(msg):
        record["ok"] = False
        record["error"] = msg
        return record

    if artifact.get("schema") != "fleet_report/v1":
        return fail(f"unexpected schema {artifact.get('schema')!r}")
    if not sessions:
        return fail("no merged sessions in the fleet artifact")
    multi = 0
    residuals = []
    for label, rep in sorted(sessions.items()):
        cons = rep.get("consistency", {})
        if not cons.get("ok"):
            return fail(f"session {label}: merge inconsistent ({cons})")
        residuals.append(cons.get("max_residual_s", 0.0))
        if cons.get("n_processes", 0) >= 2:
            multi += 1
    if not multi:
        return fail("no multi-process session: the fleet evidence must come from a "
                    ">=2-process run")
    record["multi_process_sessions"] = multi
    record["max_residual_s"] = max(residuals)
    record["stragglers"] = {
        label: (rep["straggler_ranking"][0]["process"] if rep.get("straggler_ranking")
                else None)
        for label, rep in sorted(sessions.items())
    }
    record["ok"] = True
    return record


ARTIFACT_RECORDS = {
    "supervisor_gate": supervisor_gate_record,
    "chaos_gate": chaos_gate_record,
    "serve_fleet_gate": serve_fleet_gate_record,
    "fleet_report": fleet_gate_record,
}


def run_artifact_gate(name: str) -> dict:
    """The committed artifact of gate ``name``, judged by its record; a
    missing artifact fails the gate. The record carries the card the
    artifact names."""
    spec = GATE_CONFIGS[name]
    record_fn = ARTIFACT_RECORDS[spec["kind"]]
    artifact = _artifact(os.path.join(REPO, spec["artifact"]))
    if artifact is None:
        return {"metric": f"port_ratchet_{name}", "ok": False,
                "error": f"no artifact at {spec['artifact']}"}
    return dict(record_fn(artifact), artifact=spec["artifact"], card=artifact.get("card"),
                card_count=artifact.get("card_count"))


def _child(argv, log: str, timeout: int = 3000) -> int:
    """``argv`` under this interpreter from the repository's root, its
    output into ``log``; returns the exit code."""
    with open(log, "w") as fh:
        return subprocess.run([sys.executable] + argv, cwd=REPO, stdout=fh,
                              stderr=subprocess.STDOUT, timeout=timeout).returncode


def _artifact(path: str):
    """The JSON artifact a child wrote (it exits non-zero on a failed claim
    and still writes one, which the record then judges), or ``None``."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def _fresh(path: str) -> str:
    """``path`` with no file left there from an earlier run."""
    if os.path.exists(path):
        os.remove(path)
    return path


def run_health_report_gate(workdir: str, device: str, seed: int) -> dict:
    """One rn10 pretrain epoch with the health stream and the online probe
    (the JAX gate's argv), then ``scripts/port_health_report.py`` over its
    ``events.jsonl``, judged by :func:`health_report_gate_record`."""
    os.makedirs(workdir, exist_ok=True)
    trial = "health_report_gate"
    log = os.path.join(workdir, "health_report_pretrain.log")
    code = _child([
        "-m", "simclr_pytorch_distributed_tpu_torch.train.supcon", "--device", device,
        "--dataset", "synthetic", "--model", "resnet10", "--epochs", "1", "--batch_size", "64",
        "--learning_rate", "0.05", "--print_freq", "4", "--save_freq", "1",
        "--health_freq", "2", "--online_probe", "on", "--health_policy", "warn",
        "--workdir", workdir, "--seed", str(seed), "--trial", trial], log)
    models = os.path.join(workdir, "synthetic_models")
    runs = [os.path.join(models, d) for d in (os.listdir(models) if os.path.isdir(models) else ())
            if d.endswith(f"trial_{trial}")]
    if code != 0 or not runs:
        return {"metric": "port_ratchet_health_report", "ok": False,
                "error": f"the pretrain exited {code} (log {log})"}
    events = os.path.join(max(runs, key=os.path.getmtime), "events.jsonl")
    out = _fresh(os.path.join(workdir, "health_report.json"))
    report_log = os.path.join(workdir, "health_report.log")
    code = _child([os.path.join("scripts", "port_health_report.py"), "--events", events,
                   "--json", out, "--device", device], report_log)
    artifact = _artifact(out)
    if artifact is None:
        return {"metric": "port_ratchet_health_report", "ok": False,
                "error": f"the health report wrote no artifact (exit {code}, log {report_log})"}
    return dict(health_report_gate_record(artifact), log=report_log)


def run_recipes_gate(workdir: str, device: str, seed: int) -> dict:
    """``scripts/port_recipes_eval.py --smoke`` on ``device``, judged by
    :func:`recipe_gate_record`."""
    os.makedirs(workdir, exist_ok=True)
    out = _fresh(os.path.join(workdir, "recipes_eval.json"))
    log = os.path.join(workdir, "recipes_eval.log")
    code = _child([os.path.join("scripts", "port_recipes_eval.py"), "--smoke", "--json", out,
                   "--seed", str(seed), "--device", device, "--trial", "recipes_gate",
                   "--workdir", os.path.join(workdir, "recipes_gate")], log)
    artifact = _artifact(out)
    if artifact is None:
        return {"metric": "port_ratchet_recipes", "ok": False,
                "error": f"the recipes eval wrote no artifact (exit {code}, log {log})"}
    return dict(recipe_gate_record(artifact), log=log)


def run_lint_gate(workdir: str) -> dict:
    """``scripts/port_invariant_lint.py --json`` in a child process, judged
    by :func:`lint_gate_record`. The linter exits 1 on findings and still
    writes its artifact, which the record then carries."""
    os.makedirs(workdir, exist_ok=True)
    out = _fresh(os.path.join(workdir, "port_invariant_lint.json"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "port_invariant_lint.py"),
         "--json", out], capture_output=True, text=True, timeout=600,
    )
    artifact = _artifact(out)
    if artifact is None:
        return {"metric": "port_ratchet_invariant_lint", "ok": False,
                "error": f"the linter wrote no artifact (exit {proc.returncode}): "
                         f"{proc.stderr.strip()[-400:]}"}
    return lint_gate_record(artifact)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=DEFAULT_CONFIGS,
                    choices=sorted(CONFIGS) + sorted(CE_CONFIGS) + sorted(GATE_CONFIGS))
    ap.add_argument("--epochs", type=int, default=0,
                    help="pretrain epochs, or a CE configuration's epochs (default each "
                         "configuration's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the health_report and recipes gates train (the accuracy "
                         "configurations need the card)")
    ap.add_argument("--workdir", default=os.path.join(REPO, "work_space", "port_ratchet"))
    ap.add_argument("--json", default="", help="also append the records to this file")
    args = ap.parse_args(argv)
    gates_ok = True

    def emit(record):
        print(json.dumps(record), flush=True)
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    for name in [n for n in args.configs if n in GATE_CONFIGS and
                 not GATE_CONFIGS[n]["driver"]]:
        if "artifact" in GATE_CONFIGS[name]:
            record = run_artifact_gate(name)
        else:
            record = run_lint_gate(args.workdir)
        gates_ok = gates_ok and record["ok"]
        emit(record)
    driver_gates = [n for n in args.configs if n in GATE_CONFIGS and GATE_CONFIGS[n]["driver"]]
    runs = [n for n in args.configs if n not in GATE_CONFIGS]
    if not runs and not driver_gates:
        return 0 if gates_ok else 1
    if (runs or args.device == "cuda") and not torch.cuda.is_available():
        print("port_ratchet: no CUDA device", file=sys.stderr)
        return 2
    card = card_line() if torch.cuda.is_available() else None
    if card is not None:
        print(f"nvidia-smi name, power.limit: {card}", flush=True)
    for name in driver_gates:
        gate = {"health_report": run_health_report_gate,
                "recipes": run_recipes_gate}[GATE_CONFIGS[name]["kind"]]
        record = gate(os.path.join(args.workdir, name), args.device, args.seed)
        if args.device == "cuda":
            record["card"] = card
        gates_ok = gates_ok and record["ok"]
        emit(record)
    for name in runs:
        if name in CE_CONFIGS:
            record = run_ce_config(name, args.epochs, args.workdir, args.seed)
        else:
            record = run_config(name, args.epochs, args.workdir, args.seed)
        record["card"] = card
        root = logging.getLogger()
        for handler in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
            root.removeHandler(handler)  # each run's log-ing holds its own lines only
            handler.close()
        emit(record)
    return 0 if gates_ok else 1


if __name__ == "__main__":
    sys.exit(main())
