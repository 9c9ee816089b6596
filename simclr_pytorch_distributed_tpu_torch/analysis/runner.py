"""The lint run: all rules over the port's tree, allowlist applied, one artifact.

``run_lint`` is pure file-system-in, records-out (no torch, no jax, no
imports of the analyzed code); ``build_output`` is the schema-pinned
artifact shape, the JAX linter's (``SCHEMA``, ``RULE_FAMILIES`` and the
keys), so the JAX package's ratchet gate (``scripts/ratchet.py
lint_gate_record``) reads the port's artifact unchanged, and
``scripts/port_ratchet.py`` gates on it with the same rules.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from simclr_pytorch_distributed_tpu_torch.analysis import (
    allowlist as allowlist_mod,
    rule_collectives,
    rule_donation,
    rule_hotloop,
    rule_registry,
)
from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    DEFAULT_ROOTS,
    Finding,
    load_modules,
)

SCHEMA = "invariant_lint/v1"

# the four rule families the gate requires to have run (a rules module
# silently dropped from the runner must fail the gate, not pass it)
RULE_FAMILIES = (
    "collective-schedule",
    "donation-safety",
    "hot-loop-sync",
    "contract-registry",
)

RULE_STALE = "allowlist:stale-entry"


def run_lint(
    repo_root: str,
    roots: Sequence[str] = DEFAULT_ROOTS,
    allowlist: Optional[dict] = None,
) -> dict:
    """Lint the tree. Returns::

        {
          "findings":    [Finding...]  # unallowlisted — these FAIL
          "allowlisted": [{key, reason, findings: [...]}, ...]
          "files_scanned": int,
          "rules_run": [family, ...],
        }
    """
    if allowlist is None:
        allowlist = allowlist_mod.ALLOWLIST
    allowlist_mod.validate(allowlist)
    mods = load_modules(repo_root, roots)

    # rules_run records what ACTUALLY executed (appended only after each
    # family's pass completes) — the gate's "all four families ran" check
    # must be able to catch a rule module dropped from this loop, so the
    # list must not be a constant restated here
    raw: List[Finding] = []
    rules_run: List[str] = []
    per_module_rules = (
        ("collective-schedule", rule_collectives.check_module),
        ("donation-safety", rule_donation.check_module),
        ("hot-loop-sync", rule_hotloop.check_module),
    )
    for family, check in per_module_rules:
        for mod in mods:
            raw.extend(check(mod))
        rules_run.append(family)
    raw.extend(rule_registry.check_modules(mods))
    rules_run.append("contract-registry")

    findings: List[Finding] = []
    allowlisted = {key: [] for key in allowlist}
    for f in raw:
        if f.allowlist_key in allowlist:
            allowlisted[f.allowlist_key].append(f.to_dict())
        else:
            findings.append(f)
    for key, matched in sorted(allowlisted.items()):
        if not matched:
            findings.append(Finding(
                rule=RULE_STALE,
                file="simclr_pytorch_distributed_tpu_torch/analysis/allowlist.py",
                line=0,
                why=(
                    f"allowlist entry {key!r} matches no finding: the "
                    "designed point it covered is gone — delete the entry "
                    "(the allowlist must shrink with the code)"
                ),
                allowlist_key=f"{RULE_STALE}:{key}",
            ))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return {
        "findings": findings,
        "allowlisted": [
            {"key": key, "reason": allowlist[key], "findings": matched}
            for key, matched in sorted(allowlisted.items()) if matched
        ],
        "files_scanned": len(mods),
        "rules_run": rules_run,
    }


def build_output(result: dict) -> dict:
    """The committed artifact (pure; schema pinned by tests and the
    ratchet lint gate)."""
    return {
        "schema": SCHEMA,
        "ok": not result["findings"],
        "n_findings": len(result["findings"]),
        "findings": [f.to_dict() for f in result["findings"]],
        "allowlisted": result["allowlisted"],
        "files_scanned": result["files_scanned"],
        "rules_run": result["rules_run"],
    }
