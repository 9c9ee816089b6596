"""The port's scenario-evidence gates (``scripts/port_ratchet.py``) against
the JAX ratchet's, and the two accuracy configurations the port took over.

- The four artifact gates (``supervisor_gate``, ``chaos_matrix``,
  ``serve_fleet``, ``fleet_report``): the port's copy of each record
  function gives the JAX record, field for field, on the JAX package's
  committed artifacts (``docs/evidence/supervisor_r11.json``,
  ``chaos_matrix_r16.json``, ``serve_fleet_r17.json``,
  ``fleet_report_r13.json``), and on one mutated copy per rule (a missing
  scenario, a wrong decision sequence, a collapse exit other than 3,
  unchanged ``launch_devices``, unequal digests, a failed request in the
  swap window, an anchor residual over tolerance, ...): the same ``ok`` and
  the same failing rule.
- The port's own artifacts (``docs/evidence/port_*_r21.json``, written on
  the card by ``scripts/port_supervisor_matrix.py`` and
  ``scripts/port_serve_fleet_scenario.py``) pass, name their card, and
  ``port_ratchet.py --configs supervisor_gate chaos_matrix serve_fleet
  fleet_report invariant_lint`` exits 0 with no card.
- ``supcon_rn50_50ep`` and ``rn50_200ep`` hold JAX's bars, epochs, method
  and pretrain argv.
"""

import copy
import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(REPO, "docs", "evidence")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port_ratchet = _script("port_ratchet")
jax_ratchet = _script("ratchet")

# gate -> (the JAX artifact, the record function's name)
GATES = {
    "supervisor_gate": ("supervisor_r11.json", "supervisor_gate_record"),
    "chaos_matrix": ("chaos_matrix_r16.json", "chaos_gate_record"),
    "serve_fleet": ("serve_fleet_r17.json", "serve_fleet_gate_record"),
    "fleet_report": ("fleet_report_r13.json", "fleet_gate_record"),
}


def load(name):
    with open(os.path.join(EVIDENCE, name)) as fh:
        return json.load(fh)


def both(gate, artifact):
    fn = GATES[gate][1]
    return getattr(port_ratchet, fn)(artifact), getattr(jax_ratchet, fn)(artifact)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_the_port_record_is_the_jax_record_on_the_jax_artifact(gate):
    ours, theirs = both(gate, load(GATES[gate][0]))
    assert ours == theirs
    assert ours["ok"]


def _scenario(art, name):
    return art["scenarios"][name]


def _fleet_session(art):
    return next(iter(art["sessions"].values()))


def _mutate_residual(art):
    """An anchor fit over tolerance: the reader marks the session
    inconsistent, as ``build_fleet_report`` does past its tolerance."""
    cons = _fleet_session(art)["consistency"]
    cons["max_residual_s"] = 10.0
    cons["ok"] = False


# (gate, what the mutation breaks, the mutation): each breaks one rule
MUTATIONS = [
    ("supervisor_gate", "missing scenario",
     lambda a: a["scenarios"].pop("stall")),
    ("supervisor_gate", "wrong decision sequence",
     lambda a: _scenario(a, "sigkill").update(decisions=["done"])),
    ("supervisor_gate", "scenario not ok",
     lambda a: _scenario(a, "preempt_resize").update(ok=False)),
    ("supervisor_gate", "collapse rc not 3",
     lambda a: _scenario(a, "collapse").update(rc=1)),
    ("supervisor_gate", "collapse without an observed alarm",
     lambda a: _scenario(a, "collapse").update(health_alarms_observed=0)),
    ("supervisor_gate", "stall without the watchdog's dump",
     lambda a: _scenario(a, "stall").update(watchdog_dumps_observed=0)),
    ("supervisor_gate", "resize not resumed",
     lambda a: _scenario(a, "preempt_resize").update(resumed_resized=False)),
    ("supervisor_gate", "unchanged launch_devices",
     lambda a: _scenario(a, "preempt_resize").update(launch_devices=[8, 8])),
    ("chaos_matrix", "wrong schema", lambda a: a.update(schema="chaos_matrix/v0")),
    ("chaos_matrix", "missing scenario", lambda a: a["scenarios"].pop("chaos")),
    ("chaos_matrix", "wrong decision sequence",
     lambda a: _scenario(a, "chaos").update(decisions=["restart_rebalanced", "done"])),
    ("chaos_matrix", "not landed green", lambda a: _scenario(a, "straggler").update(rc=1)),
    ("chaos_matrix", "one mitigation phase",
     lambda a: _scenario(a, "straggler").update(mitigation_events=1)),
    ("chaos_matrix", "no persistence verdict",
     lambda a: _scenario(a, "straggler").update(persistence_verdicts=0)),
    ("chaos_matrix", "share hint not carried",
     lambda a: _scenario(a, "straggler").update(launch_shares=[None, None])),
    ("chaos_matrix", "unequal digests",
     lambda a: _scenario(a, "straggler").update(bit_identical=False,
                                                control_digests=["0" * 64, "0" * 64])),
    ("chaos_matrix", "no SIGKILLed pid", lambda a: _scenario(a, "chaos").update(killed_pid=0)),
    ("chaos_matrix", "chaos without an observed alarm",
     lambda a: _scenario(a, "chaos").update(health_alarms_observed=0)),
    ("serve_fleet", "wrong schema", lambda a: a.update(schema="serve_fleet/v0")),
    ("serve_fleet", "missing phase", lambda a: a["phases"].pop("neighbors")),
    ("serve_fleet", "below the replica floor",
     lambda a: a["phases"]["spawn"].update(replicas={"0": {}})),
    ("serve_fleet", "restart on another port",
     lambda a: a["phases"]["restart"].update(port=1)),
    ("serve_fleet", "restarted replica not SIGKILLed",
     lambda a: [d.update(old_returncode=-15) for d in a["phases"]["restart"]["decisions"]]),
    ("serve_fleet", "failed request in the swap window",
     lambda a: a["phases"]["promote"].update(embed_failures={"http_503": 1})),
    ("serve_fleet", "old version not drained",
     lambda a: a["phases"]["promote"].update(drained=False)),
    ("serve_fleet", "self-neighbor below identity",
     lambda a: a["phases"]["neighbors"].update(top1_score=0.99)),
    ("serve_fleet", "a replica given up", lambda a: a.update(gave_up=[0])),
    ("fleet_report", "wrong schema", lambda a: a.update(schema="fleet_report/v0")),
    ("fleet_report", "anchor residual over tolerance", _mutate_residual),
    ("fleet_report", "no multi-process session",
     lambda a: _fleet_session(a)["consistency"].update(n_processes=1)),
    ("fleet_report", "no sessions", lambda a: a.update(sessions={})),
]


@pytest.mark.parametrize("gate,rule,mutate", MUTATIONS, ids=[f"{g}-{r}" for g, r, _ in MUTATIONS])
def test_a_broken_rule_fails_both_records_alike(gate, rule, mutate):
    art = copy.deepcopy(load(GATES[gate][0]))
    mutate(art)
    ours, theirs = both(gate, art)
    assert not ours["ok"], rule
    assert ours == theirs  # the same failing rule, the same message


@pytest.mark.parametrize("gate", sorted(GATES))
def test_the_ports_own_artifact_passes_and_names_its_card(gate):
    spec = port_ratchet.GATE_CONFIGS[gate]
    artifact = load(os.path.basename(spec["artifact"]))
    record = port_ratchet.run_artifact_gate(gate)
    assert record["ok"], record
    assert record == dict(getattr(port_ratchet, GATES[gate][1])(artifact),
                          artifact=spec["artifact"], card=artifact["card"],
                          card_count=artifact["card_count"])
    assert "NVIDIA" in artifact["card"] and artifact["card_count"] >= 1
    assert artifact["device"] == "cuda"


def test_the_port_artifacts_record_the_backend():
    sup, chaos = load("port_supervisor_r21.json"), load("port_chaos_matrix_r21.json")
    fleet = load("port_fleet_report_r21.json")
    backends = {sup["fleet_backend"], chaos["backend"], fleet["backend"],
                _scenario(sup, "preempt_resize")["backend_before"]}
    assert backends <= {"nccl", "gloo"} and len(backends) == 1


def test_the_gates_are_in_the_default_list():
    assert set(GATES) <= set(port_ratchet.DEFAULT_CONFIGS)
    assert {port_ratchet.GATE_CONFIGS[g]["kind"] for g in GATES} == set(
        port_ratchet.ARTIFACT_RECORDS)
    assert port_ratchet.SUPERVISOR_SCENARIOS == jax_ratchet.SUPERVISOR_SCENARIOS
    assert port_ratchet.CHAOS_SCENARIOS == jax_ratchet.CHAOS_SCENARIOS


def test_the_artifact_gates_and_the_linter_pass_without_a_card(capsys, tmp_path):
    code = port_ratchet.main(["--configs", "supervisor_gate", "chaos_matrix", "serve_fleet",
                              "fleet_report", "invariant_lint", "--workdir", str(tmp_path)])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert code == 0
    assert [r["ok"] for r in records] == [True] * 5


def test_a_missing_artifact_fails_its_gate(monkeypatch):
    monkeypatch.setitem(port_ratchet.GATE_CONFIGS, "serve_fleet",
                        dict(port_ratchet.GATE_CONFIGS["serve_fleet"],
                             artifact="docs/evidence/absent.json"))
    record = port_ratchet.run_artifact_gate("serve_fleet")
    assert not record["ok"] and "no artifact" in record["error"]


@pytest.mark.parametrize("name", ["supcon_rn50_50ep", "rn50_200ep"])
def test_the_accuracy_configurations_hold_the_jax_bars(name):
    ours, theirs = port_ratchet.CONFIGS[name], jax_ratchet.CONFIGS[name]
    assert ours["bar"] == theirs["bar"]
    assert ours["epochs"] == theirs["epochs"]
    assert ours["model"] == theirs["model"]
    assert ours["method"] == {"simclr": "SimCLR", "supcon": "SupCon"}[theirs["kind"]]
    argv = port_ratchet.pretrain_argv(name, ours["epochs"], "/w", 0)
    pairs = dict(zip(argv[::1], argv[1:]))
    # the JAX ratchet's pretrain argv (scripts/ratchet.py:1505-1514)
    assert {k: pairs[k] for k in ("--dataset", "--model", "--epochs", "--batch_size",
                                  "--learning_rate", "--temp", "--method", "--seed")} == {
        "--dataset": theirs["dataset"], "--model": theirs["model"],
        "--epochs": str(theirs["epochs"]), "--batch_size": "256", "--learning_rate": "0.1",
        "--temp": "0.5", "--method": ours["method"], "--seed": "0"}
    assert {"--warm", "--cosine", "--bf16"} <= set(argv)
