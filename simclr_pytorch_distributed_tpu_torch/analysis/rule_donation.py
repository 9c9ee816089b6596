"""Donation-safety lint, on the port: no host access to a tensor that an
asynchronous copy still reads or writes.

PyTorch has no buffer donation, so the JAX package's hazard (a read of a
binding after ``jit(..., donate_argnums=...)`` deleted its buffers) has no
counterpart. The hazard that takes its place in the port is the
asynchronous copy: a tensor handed to a ``non_blocking=True`` copy is read
(an upload) or written (a readback) by the device after the call returns,
so the host must not write an upload's source, or read a readback's
destination, before it waits for the copy. Either is a torn transfer: a
batch of half old and half new rows, or metrics read before they land.

Statically: a ``X.to(..., non_blocking=True)`` or ``X.cuda(non_blocking=
True)`` (the copy reads ``X``), or a ``D.copy_(S, non_blocking=True)``
(the copy writes ``D`` and reads ``S``), whose tensors are plain names or
attribute chains, followed later in the same scope by a use of one of
them, with no host wait between (``.synchronize()``: ``torch.cuda``, an
``Event``, a ``Stream``) and no rebinding of the name, is a finding. The
check is lexical, as the JAX rule's is; a copy whose tensor is kept alive
on purpose until a later wait (the serving engine's staged chunk) is an
allowlist entry with that reason.
"""

from __future__ import annotations

import ast
from typing import List

from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    Finding,
    LintModule,
    assigned_names,
    call_name,
    end_line,
    scope_nodes,
    statement_of,
)

RULE = "donation-safety:unsynced-async-copy"

# host calls that wait for the device (the ring's fetch, the serving
# engine's chunk and torch.cuda all wait through these)
WAIT_CALLS = frozenset({"synchronize"})


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) and kw.value.value is True
        for kw in call.keywords
    )


def _binding(node: ast.AST):
    """The source text of a plain name or attribute chain, else None (a
    temporary such as ``torch.from_numpy(x)`` is nobody's binding)."""
    cur = node
    while isinstance(cur, ast.Attribute):
        cur = cur.value
    return ast.unparse(node) if isinstance(cur, ast.Name) else None


def _copied(call: ast.Call) -> List[str]:
    """The bindings an asynchronous copy still touches after it returns."""
    if not isinstance(call.func, ast.Attribute) or not _non_blocking(call):
        return []
    name = call.func.attr
    if name in ("to", "cuda"):
        tensors = [call.func.value]
    elif name == "copy_":
        tensors = [call.func.value] + call.args[:1]
    else:
        return []
    return [b for b in map(_binding, tensors) if b is not None]


def _root(binding: str) -> str:
    return binding.split(".", 1)[0]


def check_module(mod: LintModule) -> List[Finding]:
    findings: List[Finding] = []
    for scope_name, scope in mod.function_scopes():
        nodes = list(scope_nodes(mod, scope))
        waits = sorted(n.lineno for n in nodes if isinstance(n, ast.Call)
                       and call_name(n) in WAIT_CALLS)
        for call in nodes:
            if not isinstance(call, ast.Call):
                continue
            bindings = _copied(call)
            if not bindings:
                continue
            stmt = statement_of(mod, call)
            after = end_line(stmt)
            until = next((w for w in waits if w > after), None)
            for binding in bindings:
                rebinds = [
                    s.lineno for s in nodes if isinstance(s, ast.stmt)
                    and s.lineno > after and _root(binding) in assigned_names(s)
                ]
                stop = min([x for x in (until, *rebinds) if x is not None], default=None)
                uses = [
                    n for n in nodes
                    if isinstance(n, (ast.Name, ast.Attribute))
                    and isinstance(getattr(n, "ctx", None), ast.Load)
                    and n.lineno > after and (stop is None or n.lineno < stop)
                    and _binding(n) == binding
                ]
                if not uses:
                    continue
                first = min(uses, key=lambda n: n.lineno)
                findings.append(Finding(
                    rule=RULE, file=mod.rel, line=first.lineno,
                    why=(
                        f"{binding!r} is handed to a non_blocking "
                        f".{call.func.attr}() at line {call.lineno} and used "
                        "again here with no host wait between: the device may "
                        "still be reading or writing it (a torn upload or "
                        "readback)"
                    ),
                    allowlist_key=f"{RULE}:{mod.rel}:{scope_name}:{binding}",
                ))
    return findings
