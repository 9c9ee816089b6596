"""The port stands alone: no JAX, no Flax/Optax, nothing of the JAX package.

Every module of ``simclr_pytorch_distributed_tpu_torch`` and
``chip_smoke.py`` is parsed with ``ast`` and must import none of
``jax``/``flax``/``optax`` nor ``simclr_pytorch_distributed_tpu``; and the
package's modules must import in a fresh interpreter where ``import jax``
fails.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
from pathlib import Path
from torch_threads import limit_threads

limit_threads()

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "simclr_pytorch_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "simclr_pytorch_distributed_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_forbidden_imports():
    offenders = [
        f"{path.relative_to(REPO)}:{line}: {name}"
        for path in _sources()
        for line, name in _imported_modules(path)
        if _forbidden(name)
    ]
    assert not offenders, offenders
    assert len(_sources()) > 15  # the scan saw the package


def test_forbidden_import_is_detected(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import jax.numpy as jnp\nfrom simclr_pytorch_distributed_tpu.ops import losses\n"
    )
    assert [name for _, name in _imported_modules(bad) if _forbidden(name)] == [
        "jax.numpy", "simclr_pytorch_distributed_tpu.ops",
    ]
    assert not _forbidden("simclr_pytorch_distributed_tpu_torch.ops")


def _package_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )


def test_package_imports_with_jax_blocked():
    modules = _package_modules()
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'simclr_pytorch_distributed_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


# the run-observability stack and the CE trainer: the JAX package's host-only
# modules the port keeps its own copies of, and the drivers built on them
OBSERVABILITY_MODULES = (
    "utils/tracing.py", "utils/prom.py", "utils/telemetry.py", "utils/guard.py",
    "utils/obs.py", "utils/profiling.py", "utils/logging_utils.py", "ops/metrics.py",
    "train/ce.py",
)


@pytest.mark.parametrize("module", OBSERVABILITY_MODULES)
def test_the_scan_covers_the_observability_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


# the data layer: the JAX package's jax-free folder reader and CIFAR fetch
# are copied, the device stores rewritten on torch
DATA_MODULES = ("data/device_store.py", "data/folder.py", "data/cifar.py", "data/pipeline.py")


@pytest.mark.parametrize("module", DATA_MODULES)
def test_the_scan_covers_the_data_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]
    # PIL only inside the decode, so that the package imports without it
    top_level = ast.parse(path.read_text()).body
    assert not [node for node in top_level if isinstance(node, (ast.Import, ast.ImportFrom))
                and any(alias.name.split(".")[0] == "PIL" for alias in node.names)
                or isinstance(node, ast.ImportFrom) and (node.module or "").startswith("PIL")]


# the SSL recipes and the native host gather: the JAX package's recipes/,
# PredictorHead and native loader, ported
RECIPE_MODULES = (
    "recipes/__init__.py", "recipes/base.py", "recipes/supcon.py", "recipes/byol.py",
    "recipes/simsiam.py", "recipes/vicreg.py", "data/native_gather.py", "models/heads.py",
    "ops/losses.py",
)


@pytest.mark.parametrize("module", RECIPE_MODULES)
def test_the_scan_covers_the_recipe_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


def test_the_native_gather_source_is_the_ports_own():
    # the port builds its own copy of the gather, never the JAX package's
    source = PACKAGE / "csrc" / "gather.cpp"
    assert source.is_file()
    text = (PACKAGE / "data" / "native_gather.py").read_text()
    assert '"csrc" / "gather.cpp"' in text and "simclr_pytorch_distributed_tpu/" not in text


# the training supervisor, its torchrun launcher and the trace report: the
# JAX package's supervise/ and scripts/trace_report.py, ported
SUPERVISE_MODULES = (
    "supervise/__init__.py", "supervise/__main__.py", "supervise/policy.py",
    "supervise/observe.py", "supervise/launch.py", "supervise/supervisor.py",
    "parallel/torchrun.py", "utils/trace_report.py",
)


@pytest.mark.parametrize("module", SUPERVISE_MODULES)
def test_the_scan_covers_the_supervise_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


# the port's scripts that drive it (the victim, the fleet launcher, the
# report's CLI): the JAX linter scans scripts/, and these import no JAX
PORT_SCRIPTS = ("port_supervisor_victim.py", "port_fleet_launcher.py", "port_trace_report.py")


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_the_port_scripts_import_no_jax(script):
    path = REPO / "scripts" / script
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


@pytest.mark.parametrize("launcher", ["run_supcon.sh", "run_linear.sh"])
def test_the_port_launchers_name_no_jax_module(launcher):
    text = (PACKAGE / launcher).read_text()
    modules = set(re.findall(r"-m\s+([\w.]+)", text))
    assert modules and all(m.startswith("simclr_pytorch_distributed_tpu_torch") for m in modules)
    assert not re.search(r"simclr_pytorch_distributed_tpu(?!_torch)|main_\w+\.py|\bjax\b", text)


# the serving stack and the replica fleet: the JAX package's serve/ and
# supervise/replica*.py, ported, with the modules they extend
SERVE_MODULES = (
    "utils/prom.py", "models/heads.py", "utils/checkpoint.py", "serve/__init__.py",
    "serve/cache.py", "serve/engine.py", "serve/batcher.py", "serve/server.py",
    "serve/fleet/__init__.py", "serve/fleet/__main__.py", "serve/fleet/retrieval.py",
    "serve/fleet/ivf.py", "serve/fleet/registry.py", "serve/fleet/frontend.py",
    "supervise/replica.py", "supervise/replica_fleet.py",
)


@pytest.mark.parametrize("module", SERVE_MODULES)
def test_the_scan_covers_the_serve_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]
    dotted = ".".join(path.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    assert dotted in _package_modules()


# the serving tests hold each module against the JAX package's: each names
# the port modules it covers (they import JAX by design; the scan above
# keeps the package itself free of it)
SERVE_TESTS = {
    "test_torch_port_serve_engine.py": ("serve.engine", "serve.cache", "models"),
    "test_torch_port_serve_batcher.py": ("serve", "serve.engine"),
    "test_torch_port_serve_server.py": ("serve", "utils"),
    "test_torch_port_serve_fleet.py": ("serve", "serve.fleet"),
    "test_torch_port_replica_fleet.py": ("supervise",),
}


@pytest.mark.parametrize("test_file", sorted(SERVE_TESTS))
def test_the_serve_tests_cover_their_modules(test_file):
    path = REPO / "tests" / test_file
    imported = {name for _, name in _imported_modules(path)}
    for module in SERVE_TESTS[test_file]:
        assert f"simclr_pytorch_distributed_tpu_torch.{module}" in imported, module


# tensor parallelism (the grid, the channel gathers, the sharded state) and
# the port's invariant linter, whose analysis/ imports neither torch nor jax
TP_AND_ANALYSIS_MODULES = (
    "parallel/mesh.py", "parallel/collectives.py", "models/resnet.py", "models/heads.py",
    "ops/fused_loss.py", "train/state.py", "train/supcon_step.py", "train/supcon.py",
    "utils/checkpoint.py", "utils/convert.py", "config.py",
    "analysis/__init__.py", "analysis/core.py", "analysis/callgraph.py",
    "analysis/allowlist.py", "analysis/rule_collectives.py", "analysis/rule_donation.py",
    "analysis/rule_hotloop.py", "analysis/rule_registry.py", "analysis/runner.py",
)


@pytest.mark.parametrize("module", TP_AND_ANALYSIS_MODULES)
def test_the_scan_covers_the_tensor_parallel_and_analysis_modules(module):
    path = PACKAGE / module
    assert path in _sources()
    names = [name for _, name in _imported_modules(path)]
    assert not [name for name in names if _forbidden(name)]
    if module.startswith("analysis/"):
        assert not [name for name in names if name.split(".")[0] in ("torch", "numpy")]


@pytest.mark.parametrize("script", ["port_invariant_lint.py", "port_ratchet.py"])
def test_the_port_lint_scripts_import_no_jax(script):
    path = REPO / "scripts" / script
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


@pytest.mark.parametrize("script", ["port_tp_nccl.py", "port_tp_fault_margin.py"])
def test_the_port_tensor_parallel_scripts_import_no_jax(script):
    path = REPO / "scripts" / script
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


# the recipes' offline readers: the health report (plain Python and json,
# the JAX package's scripts/health_report.py) and the scripts that run it
# and the recipes' evidence
RECIPE_READER_MODULES = ("utils/health_report.py", "utils/guard.py", "utils/tracing.py")


@pytest.mark.parametrize("module", RECIPE_READER_MODULES)
def test_the_scan_covers_the_recipe_readers(module):
    path = PACKAGE / module
    assert path in _sources()
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]
    # the report reads json with the standard library: nothing at import
    # time needs torch or numpy
    top_level = [alias.name if isinstance(node, ast.Import) else node.module
                 for node in ast.parse(path.read_text()).body
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for alias in (node.names if isinstance(node, ast.Import) else [None])]
    assert not [name for name in top_level if name.split(".")[0] in ("torch", "numpy")]


@pytest.mark.parametrize("script", ["port_health_report.py", "port_recipes_eval.py"])
def test_the_recipe_reader_scripts_import_no_jax(script):
    path = REPO / "scripts" / script
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


# the scenario and evidence layer: the supervisor matrix, the serve-fleet
# scenario, and the scripts they drive or judge with (the victim, the fleet
# launcher's trainer mode, the ratchet's artifact gates)
EVIDENCE_SCRIPTS = ("port_supervisor_matrix.py", "port_serve_fleet_scenario.py",
                    "port_supervisor_victim.py", "port_fleet_launcher.py", "port_ratchet.py")


@pytest.mark.parametrize("script", EVIDENCE_SCRIPTS)
def test_the_evidence_scripts_import_no_jax(script):
    path = REPO / "scripts" / script
    assert not [name for _, name in _imported_modules(path) if _forbidden(name)]


@pytest.mark.parametrize("script", EVIDENCE_SCRIPTS)
def test_the_port_linter_scans_the_evidence_scripts(script):
    from simclr_pytorch_distributed_tpu_torch.analysis.core import iter_source_files
    assert str(REPO / "scripts" / script) in set(iter_source_files(str(REPO)))


def test_the_fleet_launchers_trainer_mode_runs_no_test_child():
    """``--trainer`` starts the port's trainer through the victim; the
    tests' gloo child (``tests/torch_parallel_child.py``) is the CPU mode's
    only."""
    text = (REPO / "scripts" / "port_fleet_launcher.py").read_text()
    tree = ast.parse(text)
    layout = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "process_commands")
    trainer_part = ast.get_source_segment(text, layout).split("if not args.trainer:")[1]
    trainer_part = trainer_part.split("return out", 1)[1]
    assert "CHILD" not in trainer_part and "VICTIM" in trainer_part
