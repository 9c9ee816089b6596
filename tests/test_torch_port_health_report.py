"""The port's health report and the two gates that read the recipes'
evidence, against the JAX package's.

- ``utils/health_report.py`` against JAX ``scripts/health_report.py`` on
  the same ``events.jsonl``, with JAX's own cases
  (``tests/test_health.py:595-706``, ``tests/test_fleet.py:404``,
  ``tests/test_recipes.py``): the timeline and series, alarms and the
  collapse signature (recipe-aware), the consistency failures, rotated
  sessions, the CLI round trip; the reports equal field for field.
- ``scripts/port_ratchet.py``'s ``health_report`` and ``recipes`` gate
  records against JAX ``scripts/ratchet.py``'s on the same artifacts:
  pass, fail and skip give the same ``ok``; the gates in the default list.
- One driver run of the port (rn10 at 8 px, 4 steps, the health stream
  and the online probe on) whose ``events.jsonl`` both readers take.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

import scripts.health_report as jax_hr
import scripts.ratchet as jax_ratchet
import scripts.recipes_eval as jax_recipes_eval
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import HEALTH_METRIC_KEYS
from simclr_pytorch_distributed_tpu_torch.utils import guard
from simclr_pytorch_distributed_tpu_torch.utils import health_report as hr
from torch_threads import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port_ratchet = _script("port_ratchet")
port_recipes_eval = _script("port_recipes_eval")


def _healthy_sample():
    """JAX ``tests/test_health.py``'s healthy sample."""
    return {
        "health_align": 0.5, "health_con_top1": 30.0, "health_eff_rank": 12.0,
        "health_grad_norm": 5.0, "health_neg_max": 0.7,
        "health_neg_mean": 0.4, "health_unif": -2.0,
        "probe_loss": 2.0, "probe_top1": 25.0,
    }


def _window_event(step, **over):
    args = dict(_healthy_sample(), step=step)
    args.update(over)
    return {"name": "health_window", "track": "health", "ph": "i", "ts": 0.1 * step,
            "args": args}


def _alarm(step):
    return {"name": "health_alarm", "track": "health", "ph": "i", "ts": 0.3,
            "args": {"step": step, "policy": "warn", "findings": ["collapse: x"]}}


def _recipe_marker(recipe):
    return {"name": "run_recipe", "track": "main:guard", "ph": "i", "ts": 0.0,
            "args": {"recipe": recipe, "moco_queue": 0}}


def _both(events, **kw):
    """The port's report and JAX's on the same events; they must be equal."""
    ours, theirs = hr.build_report(events, **kw), jax_hr.build_report(events, **kw)
    assert ours == theirs
    return ours


def test_the_constants_are_the_jax_scripts_and_the_ports_own_keys():
    assert hr.SCHEMA == jax_hr.SCHEMA
    assert hr.REQUIRED_HEALTH_KEYS == jax_hr.REQUIRED_HEALTH_KEYS == HEALTH_METRIC_KEYS
    assert hr.EVENT_FLAGS == jax_hr.EVENT_FLAGS


def test_timeline_and_series():
    events = [
        {"name": "flush_boundary", "track": "main:flush", "ph": "X", "ts": 0.0, "dur": 0.01},
        _window_event(2, probe_top1=20.0),
        _window_event(4, probe_top1=40.0, health_align=0.6),
    ]
    rep = _both(events)
    assert rep["consistency"]["ok"] and rep["consistency"]["n_windows"] == 2
    assert rep["series"]["health_align"]["last"] == 0.6
    assert rep["probe"] == {"first_top1": 20.0, "last_top1": 40.0, "best_top1": 40.0,
                            "windows": 2}
    assert rep["findings"] == []


@pytest.mark.parametrize("recipe,override", [(None, None), ("supcon", None), ("byol", None),
                                             ("supcon", "simsiam")])
def test_alarms_and_the_collapse_signature(recipe, override):
    """The final window at eff_rank 2.5 is a collapse only under the
    negative-free recipes' raised bar (3.0), read from the recorded
    recipe or the override; positives and negatives both ~1 always are."""
    events = ([_recipe_marker(recipe)] if recipe else []) + [
        _window_event(2), _alarm(4), _window_event(4, health_eff_rank=2.5)]
    rep = _both(events, recipe=override)
    assert rep["alarms"] and rep["alarms"][0]["step"] == 4
    kinds = [f["kind"] for f in rep["findings"]]
    assert "health_alarm" in kinds
    resolved = override or recipe
    assert rep["recipe"] == resolved
    assert ("collapse_signature" in kinds) == (resolved in ("byol", "simsiam"))
    rep = _both(events[:-1] + [_window_event(4, health_eff_rank=1.0, health_align=1.0,
                                             health_neg_mean=1.0)], recipe=override)
    assert [f["kind"] for f in rep["findings"]].count("collapse_signature") == 2


def test_guard_events_are_findings():
    events = [_window_event(2)] + [
        {"name": name, "track": "main:guard", "ph": "i", "ts": 0.5, "args": {}}
        for name in ("nan_rollback", "nan_rollback", "preempt_exit", "stall_detected")]
    rep = _both(events)
    assert {f["kind"]: f["flag"] for f in rep["findings"]}["nan_rollback"].endswith("(x2)")


def test_consistency_failures():
    assert not _both([{"name": "x", "ph": "i", "ts": 0.0}])["consistency"]["ok"]
    broken = _window_event(2)
    del broken["args"]["health_unif"]
    rep = _both([broken])
    assert rep["consistency"]["missing_keys"] == ["health_unif"]
    assert not rep["consistency"]["ok"]
    assert not _both([_window_event(4), _window_event(2)])["consistency"]["ok"]
    with pytest.raises(ValueError, match="no events"):
        hr.build_report([])


def test_rotated_sessions(tmp_path):
    """A resumed run's timeline spans events.jsonl and events_r2.jsonl; an
    explicit rotated file selects that session alone; a torn last line is
    skipped."""
    keys = dict.fromkeys(hr.REQUIRED_HEALTH_KEYS, 1.0)

    def window(step):
        return {"name": "health_window", "track": "health", "ph": "i", "ts": 0.1 * step,
                "args": dict(keys, step=step)}

    with open(tmp_path / "events.jsonl", "w") as f:
        for s in (2, 4):
            f.write(json.dumps(window(s)) + "\n")
    with open(tmp_path / "events_r2.jsonl", "w") as f:
        for s in (6, 8):
            f.write(json.dumps(window(s)) + "\n")
        f.write('{"torn": ')
    base, r2 = str(tmp_path / "events.jsonl"), str(tmp_path / "events_r2.jsonl")
    assert hr.session_paths(base) == jax_hr.session_paths(base) == [base, r2]
    assert hr.session_paths(r2) == jax_hr.session_paths(r2) == [r2]
    assert hr.load_events(base) == jax_hr.load_events(base)
    report = _both(hr.load_events(base))
    assert [w["step"] for w in report["timeline"]] == [2, 4, 6, 8]
    assert [w["step"] for w in _both(hr.load_events(r2))["timeline"]] == [6, 8]
    ours = hr.build_output(base, report, "cpu", session_files=hr.session_paths(base))
    theirs = jax_hr.build_output(base, report, "cpu", session_files=jax_hr.session_paths(base))
    assert ours == theirs and ours["session_files"] == ["events.jsonl", "events_r2.jsonl"]


def _write_events(path, events):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_cli_round_trip(tmp_path, capsys, device):
    events = tmp_path / "events.jsonl"
    _write_events(events, [_window_event(2), _window_event(4, probe_top1=33.0)])
    out = tmp_path / "report.json"
    assert hr.main(["--events", str(events), "--json", str(out), "--device", device]) == 0
    artifact = json.loads(out.read_text())
    assert artifact["schema"] == hr.SCHEMA and artifact["device"] == device
    assert artifact["report"] == jax_hr.build_report(jax_hr.load_events(str(events)))
    assert artifact["session_files"] == ["events.jsonl"]
    printed = capsys.readouterr().out
    assert jax_hr.render_table(artifact["report"]) in printed
    assert hr.render_table(artifact["report"]) == jax_hr.render_table(artifact["report"])
    # an inconsistent stream exits 1 and names the failure; a bogus recipe is refused
    _write_events(events, [_window_event(4), _window_event(2)])
    assert hr.main(["--events", str(events)]) == 1
    assert "CONSISTENCY: FAILED" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        hr.main(["--events", str(events), "--recipe", "simclrr"])
    assert set(guard.RECIPE_HEALTH_THRESHOLDS) == {"supcon", "simclr", "byol", "simsiam",
                                                   "vicreg"}


# -- the gates: both ratchets' records on the same artifacts ----------------

def _health_artifacts():
    """(label, artifact) pairs that pass, fail and skip the health gate."""
    report = hr.build_report
    torn = _window_event(2)
    del torn["args"]["health_eff_rank"]
    no_probe = _window_event(2)
    del no_probe["args"]["probe_top1"], no_probe["args"]["probe_loss"]
    cases = [
        ("pass_cpu", [_window_event(2, probe_top1=15.0), _window_event(4, probe_top1=55.0)],
         "cpu"),
        ("low_cpu", [_window_event(2, probe_top1=11.0)], "cpu"),
        ("low_card", [_window_event(2, probe_top1=11.0)], "cuda"),
        ("alarm_card", [_window_event(2), _alarm(2)], "cuda"),
        ("alarm_cpu", [_window_event(2, probe_top1=60.0), _alarm(2)], "cpu"),
        ("torn_card", [torn], "cuda"),
        ("no_probe_cpu", [no_probe], "cpu"),
    ]
    return [(label, hr.build_output("e", report(events), device))
            for label, events, device in cases]


@pytest.mark.parametrize("label,artifact", _health_artifacts())
def test_health_report_gate_records_agree_with_the_jax_ratchet(label, artifact):
    ours = port_ratchet.health_report_gate_record(artifact)
    theirs = jax_ratchet.health_report_gate_record(artifact)
    assert ours["ok"] == theirs["ok"] == label.startswith(("pass", "low_card"))
    assert ("skipped" in ours) == ("skipped" in theirs) == (label == "low_card")
    assert ours.get("error", "").split(":")[0][:20] == theirs.get("error", "").split(":")[0][:20]
    assert port_ratchet.HEALTH_PROBE_CPU_BAR == jax_ratchet.HEALTH_PROBE_CPU_BAR


def _eval_artifact(device="cpu"):
    """JAX ``tests/test_recipes.py``'s recipes_eval artifact."""
    return {
        "schema": "recipes_eval/v1", "device": device, "smoke": True, "config": {},
        "bit_identity": {"ok": True, "epochs": 2, "steps": 10,
                         "placements": {"host": True, "device": True}},
        "recipes": {
            name: {"recipe": name.split("_")[0], "moco_queue": 0, "probe_best_top1": 60.0,
                   "probe_first_top1": 12.0, "probe_last_top1": 55.0, "windows": 3,
                   "alarms": 0, "consistency_ok": True, "thresholds": {"eff_rank_min": 2.0}}
            for name in ("supcon", "byol", "simsiam", "vicreg", "simclr_queue")
        },
    }


def _recipe_artifacts():
    out = [("pass_cpu", _eval_artifact()), ("pass_card", _eval_artifact("cuda"))]
    bad = _eval_artifact("cuda")
    bad["bit_identity"] = {"ok": False, "placements": {"host": True, "device": False}}
    out.append(("bit_card", bad))
    bad = _eval_artifact()
    bad["bit_identity"]["placements"] = {"host": True}
    out.append(("bit_incomplete_cpu", bad))
    bad = _eval_artifact("cuda")
    bad["recipes"]["byol"]["alarms"] = 2
    out.append(("alarm_card", bad))
    bad = _eval_artifact("cuda")
    bad["recipes"]["vicreg"]["consistency_ok"] = False
    out.append(("torn_card", bad))
    low = _eval_artifact()
    low["recipes"]["simsiam"]["probe_best_top1"] = 11.0
    out.append(("low_cpu", low))
    low = _eval_artifact("cuda")
    low["recipes"]["simsiam"]["probe_best_top1"] = 11.0
    out.append(("low_card", low))
    missing = _eval_artifact()
    del missing["recipes"]["vicreg"]
    out.append(("missing_cpu", missing))
    none = _eval_artifact("cuda")
    none["recipes"]["supcon"]["probe_best_top1"] = None
    out.append(("no_probe_card", none))
    return out


@pytest.mark.parametrize("label,artifact", _recipe_artifacts())
def test_recipe_gate_records_agree_with_the_jax_ratchet(label, artifact):
    ours = port_ratchet.recipe_gate_record(artifact)
    theirs = jax_ratchet.recipe_gate_record(artifact)
    assert ours["ok"] == theirs["ok"] == label.startswith(("pass", "low_card"))
    assert ("skipped" in ours) == ("skipped" in theirs) == (label.endswith("card")
                                                            and ours["ok"])


def test_the_recipe_bars_arms_and_schema_are_the_jax_scripts():
    assert port_ratchet.RECIPE_PROBE_CPU_BARS == jax_ratchet.RECIPE_PROBE_CPU_BARS
    assert [n for n, _ in port_recipes_eval.PROBE_ARMS] == [
        n for n, _ in jax_recipes_eval.PROBE_ARMS]
    for (name, extra), (_, over) in zip(port_recipes_eval.PROBE_ARMS,
                                        jax_recipes_eval.PROBE_ARMS):
        assert extra == [x for k, v in over.items() for x in (f"--{k}", str(v))], name
    out = port_recipes_eval.build_output("cpu", True, {"epochs": 1}, {"ok": True}, {})
    assert out == jax_recipes_eval.build_output("cpu", True, {"epochs": 1}, {"ok": True}, {})
    args = port_recipes_eval.parse_args(["--smoke", "--device", "cpu"])
    assert (args.epochs, args.size) == (1, 8)
    full = port_recipes_eval.parse_args([])
    assert (full.epochs, full.size, full.device) == (2, 16, "cuda")
    assert port_recipes_eval.config_of(full) == {"epochs": 2, "size": 16, "seed": 0,
                                                 "batch_size": 64, "model": "resnet10"}


def test_the_gates_are_in_the_default_list_and_run_on_the_device(tmp_path, monkeypatch,
                                                                   capsys):
    assert port_ratchet.DEFAULT_CONFIGS[:3] == ["invariant_lint", "health_report", "recipes"]
    calls = []

    def fake(kind):
        def gate(workdir, device, seed):
            calls.append((kind, device, seed))
            return {"metric": kind, "ok": kind == "health_report"}
        return gate

    monkeypatch.setattr(port_ratchet, "run_health_report_gate", fake("health_report"))
    monkeypatch.setattr(port_ratchet, "run_recipes_gate", fake("recipes"))
    code = port_ratchet.main(["--configs", "health_report", "recipes", "--device", "cpu",
                              "--seed", "3", "--workdir", str(tmp_path)])
    assert code == 1  # the recipes gate failed
    assert calls == [("health_report", "cpu", 3), ("recipes", "cpu", 3)]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in printed] == ["health_report", "recipes"]


# -- the port's own stream ----------------------------------------------------

def tiny_dataset(dataset, data_folder, **kwargs):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    images = rng.integers(0, 256, (80, 8, 8, 3)).astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


def test_the_ports_events_read_alike(tmp_path, monkeypatch):
    """A 4-step rn10 run at 8 px (byol, windows of 2 steps): both readers
    take its events.jsonl, their reports equal; the recipe's bars judge it,
    and the gate record is the JAX gate's."""
    monkeypatch.setattr(supcon, "load_dataset", tiny_dataset)
    result = supcon.main([
        "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
        "--batch_size", "16", "--epochs", "1", "--learning_rate", "0.05", "--print_freq", "2",
        "--feat_dim", "16", "--predictor_hidden", "32", "--recipe", "byol",
        "--health_freq", "2", "--online_probe", "on", "--health_policy", "warn",
        "--workdir", str(tmp_path)])
    events = os.path.join(result.save_folder, "events.jsonl")
    rep = _both(hr.load_events(events))
    assert rep["recipe"] == "byol" and rep["thresholds"]["eff_rank_min"] == 3.0
    assert rep["consistency"] == {"n_windows": 2, "monotone_ok": True, "missing_keys": [],
                                  "ok": True}
    assert [w["step"] for w in rep["timeline"]] == [0, 2]  # the health steps, 0-based
    assert rep["probe"]["windows"] == 2
    artifact = hr.build_output(events, rep, "cpu")
    ours = port_ratchet.health_report_gate_record(artifact)
    theirs = jax_ratchet.health_report_gate_record(artifact)
    assert ours["ok"] == theirs["ok"] and ours["n_windows"] == 2
