"""Hot-loop sync lint: the port's zero-sync contract as a static property.

Between flush boundaries the port's training thread only enqueues work on
the card: one ring snapshot a window, one index or window upload an epoch
or a window, and nothing that waits for the device. Three of the port's
past faults broke that contract and were found late, on the card: a
per-step blocking ``torch.tensor(..., device=...)`` in the augmentation,
a per-step preemption vote read with ``.item()``, and an indexed mask
write that waited on the card every step. This rule checks the contract
over the whole port tree, in three region kinds, the counterparts of the
JAX package's (``analysis/rule_hotloop.py``):

- **boundary loops**: the innermost ``for``/``while`` enclosing a call
  that reaches ``TelemetrySession.flush_boundary`` (directly, or through
  a local helper such as the drivers' ``submit``): the pretraining, CE
  and probe epoch loops;
- **step functions**: the functions named in :data:`KNOWN_STEP_FUNCTIONS`
  (the pretraining step, the recipe hooks, the probe and CE steps), a
  seed registry as the JAX package's ``KNOWN_DONATING_*`` are, since the
  port has no ``jax.jit`` to find them by, and the module-level functions
  of the same module that they call by bare name, transitively (a JAX
  step's callees are traced into its program; the port's run eagerly on
  every step);
- **kernel wrappers**: ``forward`` and ``backward`` of the
  ``torch.autograd.Function`` subclasses in ``ops/fused_*.py``, the
  modules that bind the hand-written kernels (the Pallas kernel builders'
  place).

Forbidden inside: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``.synchronize()`` (``torch.cuda``, an ``Event`` or a ``Stream``),
``float()``/``int()``/``bool()`` on a non-literal, ``np.asarray`` /
``np.array``, ``torch.tensor(...)``/``torch.as_tensor(...)`` with a
``device=`` or followed by ``.to(<device>)``/``.cuda()`` without
``non_blocking=True`` (a blocking upload of host values), and an indexed write of a
Python number through tensor indices (``mask[i, i] = 0``: ``index_put_``
uploads the scalar and waits for the card, the dense losses' past fault).
A DESIGNED sync point is annotated in source with ``# sync-ok: <reason>``
on (or directly above) the line; a bare marker without a reason is itself
a finding.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from simclr_pytorch_distributed_tpu_torch.analysis import callgraph
from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    Finding,
    LintModule,
    call_name,
    dotted_prefix,
)

RULE_LOOP = "hot-loop-sync:boundary-loop"
RULE_STEP = "hot-loop-sync:step-fn"
RULE_KERNEL = "hot-loop-sync:kernel-wrapper"
RULE_ANNOTATION = "hot-loop-sync:annotation-missing-reason"

# the step functions: the pretraining step and its online probe, the
# recipes' hooks, the probe's and the CE trainer's steps
KNOWN_STEP_FUNCTIONS = frozenset({
    "train_step", "probe_update", "loss", "post_step", "probe_step", "ce_step",
})

_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy", "synchronize"})
_NUMPY_MODULES = frozenset({"np", "numpy", "onp"})
_NUMPY_SYNC_FNS = frozenset({"asarray", "array"})
_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
_UPLOAD_FNS = frozenset({"tensor", "as_tensor"})


def _indexed_scalar_write(node: ast.AST) -> bool:
    """``x[i, j] = 0``: one subscript target, a number on the right, and an
    index that holds a name (a tensor of indices, not a slice or a
    literal)."""
    if not (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, (int, float))):
        return False
    index = node.targets[0].slice
    parts = index.elts if isinstance(index, ast.Tuple) else [index]
    return any(isinstance(p, ast.Name) for p in parts)


def _host_tensor(node: ast.AST) -> bool:
    """``torch.tensor(...)`` or ``torch.as_tensor(...)``: host values."""
    return (isinstance(node, ast.Call) and call_name(node) in _UPLOAD_FNS
            and dotted_prefix(node) == "torch")


def _dtype_only(node: ast.Call) -> bool:
    """``.to(torch.float32)`` or ``.to(dtype=...)``: a cast, no device."""
    return not any(kw.arg == "device" for kw in node.keywords) and all(
        isinstance(a, ast.Attribute) and isinstance(a.value, ast.Name)
        and a.value.id == "torch" for a in node.args)


def _blocking_upload(node: ast.Call) -> bool:
    """``torch.tensor(...).to(<device>)`` or ``.cuda()`` of one, without
    ``non_blocking=True``: PyTorch copies pageable host memory to the
    device and waits for the copy."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in ("to", "cuda")
            and _host_tensor(f.value)):
        return False
    if any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
           and kw.value.value is True for kw in node.keywords):
        return False
    return f.attr == "cuda" or not _dtype_only(node)


def _sync_construct(node: ast.AST) -> str:
    """Non-empty description when ``node`` is a sync-forcing call or write."""
    if _indexed_scalar_write(node):
        return ("an indexed write of a Python number through tensor indices "
                "(index_put_) uploads the scalar and waits for the device")
    if not isinstance(node, ast.Call):
        return ""
    name = call_name(node)
    if name in _SYNC_METHODS and isinstance(node.func, ast.Attribute):
        if name == "synchronize":
            return ".synchronize() blocks the host until the device catches up"
        return f".{name}() copies a device value to the host and waits for it"
    if name in _NUMPY_SYNC_FNS and dotted_prefix(node) in _NUMPY_MODULES:
        return (
            f"{dotted_prefix(node)}.{name}() materializes its argument on "
            "the host (a blocking D2H for a device tensor)"
        )
    if name in _UPLOAD_FNS and dotted_prefix(node) == "torch" and any(
            kw.arg == "device" for kw in node.keywords):
        return (
            f"torch.{name}(..., device=...) uploads host values with a "
            "blocking copy"
        )
    if _blocking_upload(node):
        return (
            f"torch.{call_name(node.func.value)}(...).{name}(...) uploads host "
            "values with a blocking copy"
        )
    if (
        name in _SYNC_BUILTINS
        and isinstance(node.func, ast.Name)
        and node.args
        and not isinstance(node.args[0], ast.Constant)
    ):
        return (
            f"{name}() on a non-literal: __{name}__ on a device tensor is a "
            "blocking readback"
        )
    return ""


def _step_functions(mod: LintModule) -> Set[ast.AST]:
    """Function defs named in :data:`KNOWN_STEP_FUNCTIONS`."""
    return {
        node for node in ast.walk(mod.tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and node.name in KNOWN_STEP_FUNCTIONS
    }


def _step_callees(mod: LintModule, steps: Set[ast.AST]) -> List[Tuple[str, ast.AST]]:
    """``(step>callee, def)`` of each module-level function of ``mod``
    that a step function calls by bare name, directly or through another
    such callee, once each (named after the first step, by name, that
    reaches it)."""
    top = {node.name: node for node in mod.tree.body
           if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: Set[str] = {fn.name for fn in steps}
    out = []
    for step in sorted(steps, key=lambda fn: (fn.name, fn.lineno)):
        stack = [step]
        while stack:
            for node in _region_nodes(stack.pop()):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
                    continue
                name = node.func.id
                if name in top and name not in seen:
                    seen.add(name)
                    out.append((f"{step.name}>{name}", top[name]))
                    stack.append(top[name])
    return out


def _is_kernel_module(mod: LintModule) -> bool:
    parts = mod.rel.split("/")
    return len(parts) >= 2 and parts[-2] == "ops" and parts[-1].startswith("fused_")


def _kernel_wrappers(mod: LintModule) -> Set[Tuple[str, ast.AST]]:
    """``(Class.method, def)`` of ``forward``/``backward`` of every
    ``torch.autograd.Function`` subclass in an ``ops/fused_*.py`` module."""
    if not _is_kernel_module(mod):
        return set()
    out = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(
            (isinstance(b, ast.Attribute) and b.attr == "Function")
            or (isinstance(b, ast.Name) and b.id == "Function")
            for b in node.bases
        ):
            continue
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    stmt.name in ("forward", "backward"):
                out.add((f"{node.name}.{stmt.name}", stmt))
    return out


def _boundary_loops(mod: LintModule) -> Set[ast.AST]:
    """Innermost loops enclosing a flush-boundary call — direct, or via a
    LOCAL helper (a function defined inside the same enclosing function,
    the drivers' ``submit`` shape). Module-level functions that reach the
    boundary (``train_one_epoch``) are deliberately not loop markers: the
    loop that calls one is the per-EPOCH driver loop, whose once-per-epoch
    host syncs (validation, the epoch's TensorBoard values) sit outside
    the boundary-to-boundary contract."""
    reachers = callgraph.flush_boundary_reachers(mod)
    local_defs: dict = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_defs.setdefault(node.name, []).append(node)
    loops: Set[ast.AST] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        hits = name == "flush_boundary"
        if not hits and isinstance(node.func, ast.Name) and name in reachers:
            owner = mod.enclosing_function(node)
            hits = owner is not None and any(
                mod.enclosing_function(d) is owner
                for d in local_defs.get(name, ())
            )
        if not hits:
            continue
        cur = mod.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                loops.add(cur)
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break  # the call runs in its own scope, not in this loop
            cur = mod.parent(cur)
    return loops


def _region_nodes(region: ast.AST) -> Iterator[ast.AST]:
    """Nodes executing in the region per iteration or call: the subtree
    minus nested function bodies (a nested def runs on ITS call — the
    drivers' consume() callbacks run on the telemetry thread, where host
    syncs are the design)."""
    stack = list(ast.iter_child_nodes(region))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_module(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    regions: List[Tuple[str, str, ast.AST]] = []
    steps = _step_functions(mod)
    for fn in steps:
        owner = mod.enclosing_function(fn)
        cls = mod.parent(fn)
        name = f"{cls.name}.{fn.name}" if isinstance(cls, ast.ClassDef) else fn.name
        regions.append((RULE_STEP, name if owner is None else f"{owner.name}.{name}", fn))
    for name, fn in _step_callees(mod, steps):
        regions.append((RULE_STEP, name, fn))
    for name, fn in _kernel_wrappers(mod):
        regions.append((RULE_KERNEL, name, fn))
    for loop in _boundary_loops(mod):
        owner = mod.enclosing_function(loop)
        owner_name = owner.name if owner is not None else "<module>"
        regions.append((RULE_LOOP, owner_name, loop))

    for rule, region_name, region in regions:
        for node in _region_nodes(region):
            desc = _sync_construct(node)
            if not desc:
                continue
            reason = mod.sync_ok_reason(node.lineno)
            sym = call_name(node) or "index_put_"
            key = f"{rule}:{mod.rel}:{region_name}:{sym}"
            if reason:
                continue  # annotated designed site, reason recorded
            if reason is not None:  # marker present but empty
                findings.append(Finding(
                    rule=RULE_ANNOTATION, file=mod.rel, line=node.lineno,
                    why=(
                        "sync-ok annotation without a reason: every "
                        "designed sync point must record WHY it is outside "
                        "the zero-sync contract"
                    ),
                    allowlist_key=f"{RULE_ANNOTATION}:{mod.rel}:"
                                  f"{region_name}:{sym}",
                ))
                continue
            where = {
                RULE_STEP: "a step function",
                RULE_KERNEL: "a kernel wrapper",
            }.get(rule, "a flush-boundary hot loop")
            findings.append(Finding(
                rule=rule, file=mod.rel, line=node.lineno,
                why=(
                    f"{desc} inside {where} ({region_name!r}): the "
                    "zero-sync contract forbids host syncs here — move it "
                    "behind the flush boundary or annotate a designed site "
                    "with '# sync-ok: <reason>'"
                ),
                allowlist_key=key,
            ))
    return findings
