"""Collective-schedule lint: the deadlock invariant, statically, on the port.

The JAX package's rule (its ``analysis/rule_collectives.py``), on the
port's collectives (``callgraph.COLLECTIVE_CALLS``: ``torch.distributed``,
the port's wrappers, the tensor-parallel model-group and data-group
collectives, ``SyncBatchNorm.apply``, the preemption vote and the
telemetry boundary exchange) and process-dependent predicates (``rank()``,
``dist.get_rank()``, ``is_main_process()``, ``local_rank()``, the
``RANK``/``LOCAL_RANK`` environment, the grid's ``data_index()`` and
``model_index()``). Every process of a group must reach each of its
collectives with an identical call count. The three static shapes that
break it:

- ``conditional-collective``: a collective (or a call reaching one)
  nested under an ``if``/``while``/ternary whose test is process-dependent,
  or short-circuited behind a process-dependent operand: one rank enters
  the all-reduce, its peers do not, and the group hangs;
- ``early-exit``: a process-dependent conditional that exits the scope
  (``return``/``raise``/``continue``/``break``/``sys.exit``) while
  collectives follow later in the same scope;
- ``swallowed-try``: a collective-reaching call inside a ``try`` whose
  handler has no unconditional top-level re-raise. Exception delivery is
  per-process, so a rank that swallows and goes on diverges its schedule
  from a peer that propagated. Designed recovery points whose raise IS
  collectively agreed (the NaN-rollback handler) belong in the allowlist
  with that reason.
"""

from __future__ import annotations

import ast
from typing import List

from simclr_pytorch_distributed_tpu_torch.analysis import callgraph
from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    Finding,
    LintModule,
    call_name,
    end_line,
    scope_nodes,
)

RULE_CONDITIONAL = "collective-schedule:conditional"
RULE_EARLY_EXIT = "collective-schedule:early-exit"
RULE_SWALLOWED = "collective-schedule:swallowed-try"

_EXIT_STMTS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _key(rule: str, mod: LintModule, scope_name: str, symbol: str) -> str:
    return f"{rule}:{mod.rel}:{scope_name}:{symbol}"


def _contains_return(stmt: ast.AST) -> bool:
    """A ``return`` anywhere in this statement (outside nested defs)."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Return):
            return True
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)
    return False


def _stmt_can_exit_handler(stmt: ast.AST) -> bool:
    """Can executing this handler statement leave the handler WITHOUT
    raising? ``return`` always can; ``continue``/``break`` can unless they
    bind to a loop nested inside the statement itself (inside a
    ``for``/``while`` only a nested ``return`` escapes the handler);
    nested function defs never execute here."""
    if isinstance(stmt, ast.Return):
        return True
    if isinstance(stmt, (ast.Continue, ast.Break)):
        return True  # binds to a loop OUTSIDE the handler at this depth
    if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
        return _contains_return(stmt)
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return False
    return any(
        _stmt_can_exit_handler(child)
        for child in ast.iter_child_nodes(stmt)
        if isinstance(child, ast.stmt)
    )


def _handler_always_reraises(stmts) -> bool:
    """Does every path through these handler statements hit a ``raise``?

    A ``raise`` that can be BYPASSED by an earlier return/continue/break —
    top-level or nested in any compound statement — is not a re-raise
    guarantee: on the rank where the bypass path is taken the exception is
    swallowed, which is the per-process divergence this rule exists to catch.
    Scanning in order: a ``raise`` before any bypass -> guaranteed; an
    ``if`` whose branches BOTH always raise -> guaranteed; any statement
    that can exit the handler -> swallowed."""
    for stmt in stmts:
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, ast.If) and stmt.orelse \
                and _handler_always_reraises(stmt.body) \
                and _handler_always_reraises(stmt.orelse):
            return True
        if _stmt_can_exit_handler(stmt):
            return False
    return False


def _exits_control_flow(if_node: ast.If) -> bool:
    """Does the if's body (or orelse) end the scope's control flow?"""
    for branch in (if_node.body, if_node.orelse):
        for stmt in branch:
            if isinstance(stmt, _EXIT_STMTS):
                return True
            if isinstance(stmt, ast.Expr) and call_name(stmt.value) == "exit":
                return True
    return False


def _under_process_dependent_branch(mod: LintModule, node: ast.AST,
                                    scope: ast.AST):
    """The innermost process-dependent conditional governing ``node``
    within ``scope`` (None when unconditional). A node sitting in the
    TEST of an if is evaluated unconditionally and is not 'under' it;
    a node in a later operand of a BoolOp is short-circuited behind the
    earlier operands."""
    child = node
    for anc in mod.ancestors(node):
        if anc is scope:
            break
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break  # the conditional would govern the DEF, not this call
        if isinstance(anc, (ast.If, ast.While)):
            # ``child`` is the direct child we arrived through: the test
            # itself is evaluated unconditionally, body/orelse are governed
            if child is not anc.test and \
                    callgraph.expr_is_process_dependent(anc.test):
                return anc
        elif isinstance(anc, ast.IfExp):
            if child is not anc.test and \
                    callgraph.expr_is_process_dependent(anc.test):
                return anc
        elif isinstance(anc, ast.BoolOp):
            try:
                idx = anc.values.index(child)
            except ValueError:
                idx = 0
            if idx > 0 and any(
                callgraph.expr_is_process_dependent(v)
                for v in anc.values[:idx]
            ):
                return anc
        child = anc
    return None


def check_module(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    reachers = callgraph.collective_reachers(mod)

    for scope_name, scope in mod.function_scopes():
        collective_calls = [
            n for n in scope_nodes(mod, scope)
            if isinstance(n, ast.Call)
            and callgraph.is_collective_call(n, reachers)
        ]
        if not collective_calls:
            continue

        # (a) conditional-collective
        for call in collective_calls:
            gov = _under_process_dependent_branch(mod, call, scope)
            if gov is not None:
                name = call_name(call)
                findings.append(Finding(
                    rule=RULE_CONDITIONAL, file=mod.rel, line=call.lineno,
                    why=(
                        f"collective-reaching call {name!r} is guarded by a "
                        f"process-dependent conditional (line {gov.lineno}):"
                        " ranks on the other branch skip the collective and"
                        " the group hangs at it"
                    ),
                    allowlist_key=_key(RULE_CONDITIONAL, mod, scope_name,
                                       name),
                ))

        # (b) process-dependent early exit with collectives after it
        for node in scope_nodes(mod, scope):
            if not isinstance(node, ast.If):
                continue
            if not callgraph.expr_is_process_dependent(node.test):
                continue
            if not _exits_control_flow(node):
                continue
            later = [
                c for c in collective_calls if c.lineno > end_line(node)
            ]
            if later:
                names = sorted({call_name(c) for c in later})
                findings.append(Finding(
                    rule=RULE_EARLY_EXIT, file=mod.rel, line=node.lineno,
                    why=(
                        "process-dependent early exit: some ranks leave "
                        f"{scope_name!r} here while others continue into "
                        f"collective call(s) {names} below — the "
                        "split-verdict deadlock shape"
                    ),
                    allowlist_key=_key(RULE_EARLY_EXIT, mod, scope_name,
                                       ",".join(names)),
                ))

        # (c) collective inside an exception-swallowing try
        for node in scope_nodes(mod, scope):
            if not isinstance(node, ast.Try):
                continue
            body_nodes = set()
            for stmt in node.body:
                body_nodes.update(ast.walk(stmt))
            in_try = [c for c in collective_calls if c in body_nodes]
            if not in_try:
                continue
            for handler in node.handlers:
                if _handler_always_reraises(handler.body):
                    continue
                names = sorted({call_name(c) for c in in_try})
                htype = (
                    ast.unparse(handler.type) if handler.type is not None
                    else "BaseException"
                )
                findings.append(Finding(
                    rule=RULE_SWALLOWED, file=mod.rel, line=handler.lineno,
                    why=(
                        f"'except {htype}' swallows (no unconditional "
                        f"top-level re-raise) around collective call(s) "
                        f"{names}: exception delivery is per-process, so a "
                        "locally-swallowed failure desynchronizes this "
                        "rank's collective schedule from its peers'"
                    ),
                    allowlist_key=_key(
                        RULE_SWALLOWED, mod, scope_name,
                        f"{htype}:{','.join(names)}",
                    ),
                ))
    return findings
