"""The port's static invariant linter (simclr_pytorch_distributed_tpu_torch/analysis/).

- The KNOWN-BAD fixture corpus (``tests/torch_lint_fixtures/``): one
  minimal reconstruction per rule, each firing exactly its finding, and
  three regression fixtures of the port's past faults (a blocking upload
  in the augmentation, a per-step preemption vote read with ``.item()``,
  an indexed mask write), each of which fires.
- The CLEAN-TREE contract: the port tree has zero unallowlisted findings,
  every allowlist entry carries a reason and is used, a stale entry is a
  finding, the CLI runs without torch and writes the artifact that the
  ratchet gates (the port's and the JAX package's) pass.
- Parity with the JAX package's linter on the same source texts: the
  shared machinery (``core``, ``callgraph``, ``allowlist.validate``, the
  runner's stale-entry logic, ``build_output``) and the contract-registry
  rule give the same findings; ``SCHEMA`` and ``RULE_FAMILIES`` are equal.

Both linters run on stdlib ``ast``: no driver runs and no device here.
"""

import ast
import glob
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from simclr_pytorch_distributed_tpu.analysis import allowlist as jax_allowlist
from simclr_pytorch_distributed_tpu.analysis import callgraph as jax_callgraph
from simclr_pytorch_distributed_tpu.analysis import core as jax_core
from simclr_pytorch_distributed_tpu.analysis import rule_registry as jax_registry
from simclr_pytorch_distributed_tpu.analysis import runner as jax_runner
from simclr_pytorch_distributed_tpu_torch.analysis import (
    allowlist,
    callgraph,
    core,
    rule_collectives,
    rule_donation,
    rule_hotloop,
    rule_registry,
    runner,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
JAX_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
ANALYSIS = os.path.join(REPO, "simclr_pytorch_distributed_tpu_torch", "analysis")


def fixture(name: str) -> core.LintModule:
    return core.load_module(os.path.join(FIXTURES, name), repo_root=FIXTURES)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the known-bad corpus: each rule fires exactly once --------------------

BAD = [
    ("bad_conditional_collective.py", rule_collectives, [rule_collectives.RULE_CONDITIONAL],
     "all_reduce"),
    ("bad_tp_index_collective.py", rule_collectives, [rule_collectives.RULE_CONDITIONAL],
     "gather_channels"),
    ("bad_env_rank_collective.py", rule_collectives, [rule_collectives.RULE_CONDITIONAL],
     "barrier"),
    ("bad_sync_bn_collective.py", rule_collectives, [rule_collectives.RULE_CONDITIONAL],
     "apply"),
    ("bad_early_exit_collective.py", rule_collectives, [rule_collectives.RULE_EARLY_EXIT],
     "requested_global"),
    ("bad_swallowed_collective.py", rule_collectives, [rule_collectives.RULE_SWALLOWED],
     "flush_boundary"),
    ("bad_async_copy.py", rule_donation, [rule_donation.RULE], "'host'"),
    ("bad_hotloop_sync.py", rule_hotloop,
     sorted([rule_hotloop.RULE_LOOP, rule_hotloop.RULE_ANNOTATION]), "sync-ok"),
    ("bad_step_fn_sync.py", rule_hotloop, [rule_hotloop.RULE_STEP], "float()"),
    ("ops/fused_bad_wrapper.py", rule_hotloop, [rule_hotloop.RULE_KERNEL], "FusedBad.forward"),
]


@pytest.mark.parametrize("name,rule_mod,rules,mention", BAD,
                         ids=[b[0] for b in BAD])
def test_bad_fixture_fires_exactly_its_finding(name, rule_mod, rules, mention):
    findings = rule_mod.check_module(fixture(name))
    assert sorted(f.rule for f in findings) == rules
    assert any(mention in f.why for f in findings), [f.why for f in findings]
    for f in findings:
        assert f.file == name and f.line > 0
        assert f.allowlist_key.startswith(f"{f.rule}:{name}:")


REGISTRY_BAD = [
    ("bad_metric_keys.py", rule_registry.RULE_KEYS_SORTED),
    ("bad_flag_type.py", rule_registry.RULE_FLAG_TYPE),
    ("bad_flag_inline.py", rule_registry.RULE_FLAG_INLINE),
    ("bad_flag_default.py", rule_registry.RULE_FLAG_DEFAULT),
    ("scripts/bad_schema_literal.py", rule_registry.RULE_SCHEMA),
]


@pytest.mark.parametrize("name,rule", REGISTRY_BAD, ids=[b[0] for b in REGISTRY_BAD])
def test_registry_fixture_fires_exactly_its_finding(name, rule):
    assert [f.rule for f in rule_registry.check_modules([fixture(name)])] == [rule]


def test_metric_keys_defined_twice_fire_once():
    mods = [fixture("bad_metric_keys_dup.py"), fixture("bad_metric_keys_copy.py")]
    findings = [f for f in rule_registry.check_modules(mods)
                if f.rule == rule_registry.RULE_KEYS_DUP]
    assert len(findings) == 1 and "FIXTURE_DUP_METRIC_KEYS" in findings[0].why


REGRESSIONS = [
    ("regress_augment_upload.py", rule_hotloop.RULE_LOOP, "torch.tensor(..., device=...)"),
    ("regress_preempt_vote.py", rule_hotloop.RULE_LOOP, ".item()"),
    ("regress_mask_write.py", rule_hotloop.RULE_STEP, "index_put_"),
    ("regress_tp_norm_upload.py", rule_hotloop.RULE_STEP, "torch.tensor(...).to(...)"),
]


@pytest.mark.parametrize("name,rule,mention", REGRESSIONS, ids=[r[0] for r in REGRESSIONS])
def test_regression_fixture_of_a_past_fault_fires(name, rule, mention):
    findings = rule_hotloop.check_module(fixture(name))
    assert [f.rule for f in findings] == [rule]
    assert mention in findings[0].why


def test_clean_fixtures_stay_silent():
    """The clean halves of the fixtures: the wait before the read, the
    other Function's apply, the clean wrapper, the uniform short-circuit."""
    assert "metrics_after_wait" not in " ".join(
        f.allowlist_key for f in rule_donation.check_module(fixture("bad_async_copy.py")))
    assert "FusedClean" not in " ".join(
        f.why for f in rule_hotloop.check_module(fixture("ops/fused_bad_wrapper.py")))
    assert not [f for f in rule_collectives.check_module(fixture("bad_env_rank_collective.py"))
                if f.rule == rule_collectives.RULE_EARLY_EXIT]


# the port's asynchronous copies the donation-safety rule reads: each is
# clean (a wait before the use, a temporary, or no use after) but the
# serving engine's staged chunk, which the allowlist carries
ASYNC_COPY_SITES = [
    ("ops/metrics.py", 1, 0), ("serve/engine.py", 2, 2), ("ops/augment.py", 1, 0),
    ("data/device_store.py", 2, 0), ("train/linear.py", 2, 0),
]


@pytest.mark.parametrize("rel,copies,findings", ASYNC_COPY_SITES,
                         ids=[s[0] for s in ASYNC_COPY_SITES])
def test_donation_rule_reads_each_async_copy_of_the_port(rel, copies, findings):
    mod = core.load_module(os.path.join(REPO, "simclr_pytorch_distributed_tpu_torch", rel),
                           repo_root=REPO)
    calls = [n for n in ast.walk(mod.tree)
             if isinstance(n, ast.Call) and rule_donation._non_blocking(n)]
    assert len(calls) == copies
    found = rule_donation.check_module(mod)
    assert len(found) == findings
    assert all(f.allowlist_key in allowlist.ALLOWLIST for f in found)


# -- the clean tree --------------------------------------------------------

@pytest.fixture(scope="module")
def lint():
    return runner.run_lint(REPO)


def test_port_tree_is_clean(lint):
    assert lint["findings"] == [], "\n".join(f.render() for f in lint["findings"])
    assert lint["rules_run"] == list(runner.RULE_FAMILIES)
    scanned = set(core.iter_source_files(REPO))
    assert os.path.join(REPO, "scripts", "port_invariant_lint.py") in scanned
    assert not any(p.endswith("chip_smoke.py") or "/tests/" in p for p in scanned)
    assert lint["files_scanned"] == len(scanned) > 60


def test_every_allowlist_entry_has_a_reason_and_is_used(lint):
    allowlist.validate()
    used = {a["key"] for a in lint["allowlisted"]}
    assert used == set(allowlist.ALLOWLIST)
    for a in lint["allowlisted"]:
        assert a["reason"].strip() and a["findings"]


def test_a_stale_allowlist_entry_is_a_finding():
    extra = dict(allowlist.ALLOWLIST, **{"hot-loop-sync:step-fn:nowhere.py:f:item": "gone"})
    result = runner.run_lint(REPO, allowlist=extra)
    assert [f.rule for f in result["findings"]] == [runner.RULE_STALE]
    assert "nowhere.py" in result["findings"][0].why


def test_an_entry_without_a_reason_is_rejected():
    with pytest.raises(ValueError, match="carries no reason"):
        allowlist.validate({"some:key": "  "})


def test_analysis_imports_neither_torch_nor_jax():
    stdlib = {"__future__", "ast", "dataclasses", "glob", "os", "re", "typing"}
    for path in glob.glob(os.path.join(ANALYSIS, "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in stdlib or name.startswith(
                    "simclr_pytorch_distributed_tpu_torch.analysis"), (path, name)


def test_cli_runs_without_torch_and_writes_the_artifact(tmp_path):
    out = tmp_path / "lint.json"
    code = (
        "import runpy, sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        f"sys.argv = ['port_invariant_lint.py', '--json', {str(out)!r}]\n"
        "runpy.run_path('scripts/port_invariant_lint.py', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    artifact = json.loads(out.read_text())
    assert artifact["schema"] == runner.SCHEMA and artifact["ok"]
    assert _script("port_ratchet").lint_gate_record(artifact)["ok"]


def test_ratchet_gates_of_both_packages_pass_the_artifact(lint):
    artifact = runner.build_output(lint)
    assert _script("port_ratchet").lint_gate_record(artifact)["ok"]
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        assert _script("ratchet").lint_gate_record(artifact)["ok"]
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


def test_port_ratchet_gate_fails_on_a_finding(lint):
    artifact = runner.build_output(lint)
    artifact["findings"] = [{"file": "x.py", "line": 1, "rule": "hot-loop-sync:step-fn"}]
    artifact["ok"] = False
    record = _script("port_ratchet").lint_gate_record(artifact)
    assert not record["ok"] and "x.py:1" in record["error"]


def test_port_ratchet_default_list_includes_the_lint_gate():
    ratchet = _script("port_ratchet")
    assert "invariant_lint" in ratchet.DEFAULT_CONFIGS
    assert ratchet.GATE_CONFIGS["invariant_lint"]["kind"] == "invariant_lint"


def test_jax_linter_stays_clean_over_the_port_scripts():
    result = jax_runner.run_lint(REPO)
    assert not [f for f in result["findings"] if f.file.startswith("scripts/port_")]


# -- parity with the JAX package's linter ----------------------------------

def test_schema_and_rule_families_are_the_jax_runners():
    assert runner.SCHEMA == jax_runner.SCHEMA
    assert runner.RULE_FAMILIES == jax_runner.RULE_FAMILIES
    assert runner.RULE_STALE == jax_runner.RULE_STALE


def corpus():
    """Every fixture source of both corpora: ``(root, relative path)``."""
    out = []
    for root in (FIXTURES, JAX_FIXTURES):
        for path in sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True)):
            out.append((root, os.path.relpath(path, root)))
    return out


def core_view(core_mod, root, rel):
    mod = core_mod.load_module(os.path.join(root, rel), repo_root=root)
    view = {"scopes": [], "calls": [], "stmts": [], "sync_ok": []}
    for qual, scope in mod.function_scopes():
        view["scopes"].append((qual, sum(1 for _ in core_mod.scope_nodes(mod, scope))))
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            stmt = core_mod.statement_of(mod, node)
            view["calls"].append((node.lineno, core_mod.call_name(node),
                                  core_mod.dotted_prefix(node), type(stmt).__name__,
                                  core_mod.end_line(stmt)))
        if isinstance(node, ast.stmt):
            view["stmts"].append((node.lineno, sorted(core_mod.assigned_names(node))))
    view["sync_ok"] = [mod.sync_ok_reason(i) for i in range(1, len(mod.source_lines) + 2)]
    return view


@pytest.mark.parametrize("root,rel", corpus(), ids=[f"{os.path.basename(r)}/{p}"
                                                     for r, p in corpus()])
def test_core_and_callgraph_read_a_source_as_jax_does(root, rel):
    assert core_view(core, root, rel) == core_view(jax_core, root, rel)
    mod = core.load_module(os.path.join(root, rel), repo_root=root)
    jmod = jax_core.load_module(os.path.join(root, rel), repo_root=root)
    for targets in (jax_callgraph.COLLECTIVE_CALLS, callgraph.COLLECTIVE_CALLS,
                    frozenset({"flush_boundary"})):
        assert callgraph.reaching_functions(mod, targets) == \
            jax_callgraph.reaching_functions(jmod, targets)
    assert callgraph.flush_boundary_reachers(mod) == jax_callgraph.flush_boundary_reachers(jmod)


@pytest.mark.parametrize("entries", [{"k": "a reason"}, {"k": ""}, {"k": "  "}, {"k": None},
                                     {}])
def test_allowlist_validate_agrees_with_jax(entries):
    outcomes = []
    for validate in (allowlist.validate, jax_allowlist.validate):
        try:
            validate(entries)
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_stale_entry_logic_and_build_output_agree_with_jax(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "clean.py").write_text("def f(x):\n    return x + 1\n")
    stale = {"hot-loop-sync:step-fn:pkg/clean.py:f:item": "a designed point that left"}
    ours = runner.run_lint(str(tmp_path), roots=("pkg",), allowlist=stale)
    theirs = jax_runner.run_lint(str(tmp_path), roots=("pkg",), allowlist=stale)

    def strip(result):
        out = runner.build_output(result)
        for f in out["findings"]:
            f.pop("file")
        return out

    assert strip(ours) == strip(theirs)
    assert [f.rule for f in ours["findings"]] == [runner.RULE_STALE]
    assert runner.build_output(theirs) == jax_runner.build_output(theirs)


REGISTRY_SOURCES = [
    ["bad_metric_keys.py"], ["bad_metric_keys_dup.py", "bad_metric_keys_copy.py"],
    ["bad_flag_type.py"], ["bad_flag_inline.py"], ["bad_flag_default.py"],
    ["scripts/bad_schema_literal.py"],
]


@pytest.mark.parametrize("root", (FIXTURES, JAX_FIXTURES), ids=("port", "jax"))
@pytest.mark.parametrize("names", REGISTRY_SOURCES, ids=[n[0] for n in REGISTRY_SOURCES])
def test_contract_registry_rule_agrees_with_jax(root, names):
    ours = rule_registry.check_modules(
        [core.load_module(os.path.join(root, n), repo_root=root) for n in names])
    theirs = jax_registry.check_modules(
        [jax_core.load_module(os.path.join(root, n), repo_root=root) for n in names])
    assert [f.to_dict() for f in ours] == [f.to_dict() for f in theirs]
    assert ours
