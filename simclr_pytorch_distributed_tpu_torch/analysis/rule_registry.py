"""Contract-registry checks: the port's writer/reader registries, pinned.

The JAX package's checks (its ``analysis/rule_registry.py``), kept check
for check so that the two linters judge a source text alike, on the port:

- **metric-key tuples** (``*_METRIC_KEYS``, recipes' ``metric_keys``): the
  ring column order is ``sorted(keys)`` on BOTH the step that writes a row
  and the host that reads it (``train/supcon_step.metric_keys``), so
  declarations must be sorted and unique, and each registry name must have
  ONE defining module: readers import it, they never re-type it;
- **schema stamps**: the port's scripts pin their artifact schema in a
  module constant (``SCHEMA = "x/v1"``) that ``build_output`` references;
  a dict literal carrying a hardcoded ``"schema": "..."`` string bypasses
  the pin;
- **shared trainer flags**: flags the pretraining, probe and CE parsers
  share must be registered through the shared helper in the port's
  ``config.py`` (``add_runtime_flags``): each registry flag reaches every
  parser through one helper, with dataclass defaults that agree, and any
  flag present in several parsers must agree on its argparse TYPE.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    Finding,
    LintModule,
    call_name,
)

RULE_KEYS_SORTED = "contract-registry:metric-keys-unsorted"
RULE_KEYS_DUP = "contract-registry:metric-keys-multi-source"
RULE_SCHEMA = "contract-registry:schema-literal-unpinned"
RULE_FLAG_TYPE = "contract-registry:flag-type-mismatch"
RULE_FLAG_DEFAULT = "contract-registry:flag-default-mismatch"
RULE_FLAG_INLINE = "contract-registry:shared-flag-not-shared"

_METRIC_KEYS_RE = re.compile(r"^[A-Z0-9_]*METRIC_KEYS$")

# The flags every trainer shares (the runtime and observability surface,
# the port's config.add_runtime_flags). These must be registered by ONE
# shared helper and their dataclass defaults must agree across configs;
# recipe hyperparameters (--learning_rate & co) deliberately differ per
# stage and are only type-checked. The JAX package's set, less
# --compile_cache (the port compiles no XLA programs) and with
# --no_download, which the port's helper registers too.
SHARED_RUNTIME_FLAGS = frozenset({
    "telemetry", "data_placement", "data_window_batches",
    "device_budget_mb", "no_download",
    "trace_dir", "trace_start_step", "trace_steps",
    "flight_recorder", "watchdog_secs", "metrics_port", "metrics_host",
})


# -- metric-key tuples ----------------------------------------------------

def _literal_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Tuple) and all(
        isinstance(e, ast.Constant) and isinstance(e.value, str)
        for e in node.elts
    ):
        return tuple(e.value for e in node.elts)
    return None


def _metric_key_assignments(mod: LintModule):
    """``(name, values, lineno)`` for every metric-key tuple literal —
    module-level ``*_METRIC_KEYS`` constants and class-level
    ``metric_keys`` recipe declarations alike."""
    for node in ast.walk(mod.tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if not (_METRIC_KEYS_RE.match(t.id) or t.id == "metric_keys"):
                continue
            values = _literal_str_tuple(value)
            if values is not None:
                yield t.id, values, node.lineno


def check_metric_keys(mods: List[LintModule]) -> List[Finding]:
    findings: List[Finding] = []
    definers: Dict[str, List[str]] = {}
    for mod in mods:
        for name, values, lineno in _metric_key_assignments(mod):
            expect = tuple(sorted(set(values)))
            if values != expect:
                findings.append(Finding(
                    rule=RULE_KEYS_SORTED, file=mod.rel, line=lineno,
                    why=(
                        f"{name} = {values!r} is not sorted+unique "
                        f"(expected {expect!r}): the ring column order is "
                        "sorted(keys) on writer AND reader, so the "
                        "declaration must read in column order and carry "
                        "no duplicates"
                    ),
                    allowlist_key=f"{RULE_KEYS_SORTED}:{mod.rel}:{name}",
                ))
            if _METRIC_KEYS_RE.match(name):
                definers.setdefault(name, []).append(mod.rel)
    for name, files in sorted(definers.items()):
        if len(files) > 1:
            for rel in files[1:]:
                findings.append(Finding(
                    rule=RULE_KEYS_DUP, file=rel, line=0,
                    why=(
                        f"{name} is literally re-defined here AND in "
                        f"{files[0]}: ring registries have one source — "
                        "readers must import it, or the writer/reader "
                        "column derivations drift"
                    ),
                    allowlist_key=f"{RULE_KEYS_DUP}:{rel}:{name}",
                ))
    return findings


# -- schema stamps --------------------------------------------------------

def check_schema_stamps(mods: List[LintModule]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in mods:
        if not mod.rel.startswith("scripts/"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant) and k.value == "schema"):
                    continue
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    findings.append(Finding(
                        rule=RULE_SCHEMA, file=mod.rel, line=v.lineno,
                        why=(
                            f'hardcoded "schema": {v.value!r} in a dict '
                            "literal: pin it to a module-level *SCHEMA* "
                            "constant so the writer and every gate/reader "
                            "reference one definition"
                        ),
                        allowlist_key=f"{RULE_SCHEMA}:{mod.rel}:{v.value}",
                    ))
    return findings


# -- shared trainer flags -------------------------------------------------

def _flag_registrations(fn: ast.AST) -> List[dict]:
    """Direct flag registrations inside one function body: add_argument
    calls and the _add_bool_flag helper shorthand."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name == "add_argument" and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and \
                node.args[0].value.startswith("--"):
            kw = {k.arg: k.value for k in node.keywords}
            action = kw.get("action")
            if "type" in kw:
                ftype = ast.unparse(kw["type"])
            elif isinstance(action, ast.Constant):
                ftype = str(action.value)
            else:
                ftype = "str"  # argparse default
            out.append({
                "flag": node.args[0].value[2:],
                "type": ftype,
                "default": kw.get("default"),
                "line": node.lineno,
            })
        elif name == "_add_bool_flag" and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant):
            out.append({
                "flag": node.args[1].value,
                "type": "store_true",
                "default": None,
                "line": node.lineno,
            })
    return out


def _dataclass_defaults(mod: LintModule) -> Dict[str, Dict[str, str]]:
    """class name -> {field: unparsed default} for module dataclasses."""
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        fields = {}
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                fields[stmt.target.id] = ast.unparse(stmt.value)
        if fields:
            out[node.name] = fields
    return out


def _resolve_default(value: Optional[ast.AST], dc_fields: Dict[str, str]
                     ) -> Optional[str]:
    """Normalized default: ``d.<field>`` resolves through the parser's
    dataclass instance; literals unparse directly; unresolvable -> None
    (not compared)."""
    if value is None:
        return None
    if isinstance(value, ast.Attribute) and isinstance(value.value, ast.Name):
        return dc_fields.get(value.attr)
    try:
        return ast.unparse(value)
    except Exception:  # pragma: no cover - defensive
        return None


def check_parser_flags(mod: LintModule) -> List[Finding]:
    """Flag-consistency over one module's ``*_parser`` functions (the
    config.py surface; fixtures use the same convention)."""
    findings: List[Finding] = []
    fns = {
        node.name: node for node in mod.tree.body
        if isinstance(node, ast.FunctionDef)
    }
    classes = _dataclass_defaults(mod)

    # which dataclass instance each parser function reads defaults from
    # (the `d = SupConConfig()` convention)
    def dc_for(fn: ast.AST) -> Dict[str, str]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                cname = call_name(node.value)
                if cname in classes:
                    return classes[cname]
        return {}

    # registrations per top-level parser, resolving helper calls one level
    # (helpers themselves may not call further helpers — they don't here)
    parsers: Dict[str, Dict[str, List[dict]]] = {}
    for name, fn in fns.items():
        if not name.endswith("_parser"):
            continue
        dc_fields = dc_for(fn)
        flags: Dict[str, List[dict]] = {}

        def add(regs, registered_by, fields):
            for r in regs:
                entry = dict(r)
                entry["registered_by"] = registered_by
                entry["default_resolved"] = _resolve_default(
                    r["default"], fields
                )
                flags.setdefault(r["flag"], []).append(entry)

        add(_flag_registrations(fn), name, dc_fields)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                helper = fns.get(node.func.id)
                if helper is not None and node.func.id != "_add_bool_flag" \
                        and _flag_registrations(helper):
                    add(_flag_registrations(helper), node.func.id, dc_fields)
        parsers[name] = flags

    if len(parsers) < 2:
        return findings

    all_flags = sorted({f for flags in parsers.values() for f in flags})
    for flag in all_flags:
        present = {
            pname: flags[flag] for pname, flags in parsers.items()
            if flag in flags
        }
        if len(present) < 2:
            continue
        # TYPE agreement for every shared flag
        types = {e["type"] for entries in present.values() for e in entries}
        if len(types) > 1:
            line = min(e["line"] for v in present.values() for e in v)
            findings.append(Finding(
                rule=RULE_FLAG_TYPE, file=mod.rel, line=line,
                why=(
                    f"--{flag} is registered with different argparse types "
                    f"across parsers ({sorted(types)}): the trainers parse "
                    "the same CLI surface, so a type drift silently changes "
                    "values on one stage only"
                ),
                allowlist_key=f"{RULE_FLAG_TYPE}:{mod.rel}:{flag}",
            ))
        if flag not in SHARED_RUNTIME_FLAGS:
            continue
        # registry flags: must come through one shared helper...
        inline = sorted({
            pname for pname, entries in present.items()
            if any(e["registered_by"] == pname for e in entries)
        })
        if inline:
            line = min(e["line"] for v in present.values() for e in v)
            findings.append(Finding(
                rule=RULE_FLAG_INLINE, file=mod.rel, line=line,
                why=(
                    f"shared runtime flag --{flag} is registered inline in "
                    f"{inline} instead of through the shared helper: the "
                    "flag-consistency contract verifies one registry, not "
                    "hand-synced copies"
                ),
                allowlist_key=f"{RULE_FLAG_INLINE}:{mod.rel}:{flag}",
            ))
        # ...and their resolved defaults must agree across configs
        defaults = {
            e["default_resolved"]
            for entries in present.values() for e in entries
            if e["default_resolved"] is not None
        }
        if len(defaults) > 1:
            line = min(e["line"] for v in present.values() for e in v)
            findings.append(Finding(
                rule=RULE_FLAG_DEFAULT, file=mod.rel, line=line,
                why=(
                    f"shared runtime flag --{flag} resolves to different "
                    f"defaults across the trainer configs "
                    f"({sorted(defaults)}): the shared surface must behave "
                    "identically on all three trainers"
                ),
                allowlist_key=f"{RULE_FLAG_DEFAULT}:{mod.rel}:{flag}",
            ))
    return findings


def check_module_flags(mods: List[LintModule]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in mods:
        if any(
            isinstance(n, ast.FunctionDef) and n.name.endswith("_parser")
            for n in mod.tree.body
        ):
            findings.extend(check_parser_flags(mod))
    return findings


def check_modules(mods: List[LintModule]) -> List[Finding]:
    return (
        check_metric_keys(mods)
        + check_schema_stamps(mods)
        + check_module_flags(mods)
    )
