"""Shared machinery for the AST rules: parsed modules, findings, scopes.

The port's own copy of the JAX package's ``analysis/core.py`` (the port
imports nothing of that package): the same ``Finding``, ``LintModule``,
scope walks and call-name helpers, so the two linters read a source text
alike. Everything here is stdlib-only and PURE (no imports of the code
under analysis: the linter never executes the tree it inspects, and runs
without torch or jax). The roots differ: the port package and the port's
scripts (``scripts/port_*.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

# Inline suppression for the hot-loop rule's annotated flush-boundary
# sites: a sync-forcing construct on a line (or directly under a line)
# carrying ``# sync-ok: <reason>`` is a DESIGNED sync point. The reason is
# mandatory — a bare marker is itself a finding (the allowlist convention:
# every exception carries its why).
SYNC_OK_RE = re.compile(r"#\s*sync-ok\s*:?\s*(?P<reason>.*)$")


@dataclasses.dataclass
class Finding:
    """One rule violation: ``rule`` (family:check id), ``file:line``, the
    ``why`` a reviewer needs, and the stable ``allowlist_key`` an entry in
    :mod:`.allowlist` must match to accept it as a designed matched point.
    The key deliberately excludes line numbers so unrelated edits above a
    designed point do not invalidate its allowlist entry."""

    rule: str
    file: str
    line: int
    why: str
    allowlist_key: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: [{self.rule}] {self.why}\n"
            f"    allowlist_key: {self.allowlist_key}"
        )


class LintModule:
    """One parsed source file: tree + source lines + parent links.

    ``rel`` is the repo-relative posix path (the coordinate findings and
    allowlist keys use, so artifacts are machine-independent).
    """

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    # -- navigation ------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        """Innermost-first chain of ancestors up to the Module."""
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def function_scopes(self) -> List[Tuple[str, ast.AST]]:
        """``(qualname, node)`` for the module itself and every function
        (nested functions get dotted qualnames). Each node later owns
        exactly the statements whose *innermost* enclosing function is it —
        see :meth:`scope_of`."""
        out: List[Tuple[str, ast.AST]] = [("<module>", self.tree)]

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    out.append((qual, child))
                    visit(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return out

    def scope_of(self, node: ast.AST) -> ast.AST:
        """The innermost function owning ``node`` (or the Module)."""
        fn = self.enclosing_function(node)
        return fn if fn is not None else self.tree

    # -- inline annotations ----------------------------------------------
    def sync_ok_reason(self, lineno: int) -> Optional[str]:
        """The ``# sync-ok: reason`` annotation covering ``lineno`` — on
        the line itself or the line directly above. Returns the reason
        string ('' when the marker carries none), or None when the line is
        unannotated."""
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.source_lines):
                m = SYNC_OK_RE.search(self.source_lines[ln - 1])
                if m:
                    return m.group("reason").strip()
        return None


def scope_nodes(mod: LintModule, scope: ast.AST) -> Iterator[ast.AST]:
    """All nodes whose innermost enclosing function is ``scope`` — i.e. the
    code that EXECUTES when that scope runs, excluding nested function
    bodies (they execute on their own call, in their own scope pass)."""
    for node in ast.walk(scope):
        if node is scope:
            continue
        if mod.scope_of(node) is scope:
            yield node


def call_name(node: ast.AST) -> Optional[str]:
    """The terminal name of a call target: ``f(...)`` -> 'f',
    ``a.b.f(...)`` -> 'f'. Terminal-name matching is the deliberate
    resolution level: the repo's collectives are reached both as bare
    imports and as module/method attributes, and a rare same-name
    false positive is an allowlist entry, not a blind spot."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def dotted_prefix(node: ast.Call) -> Optional[str]:
    """``np.asarray(...)`` -> 'np'; None for bare-name calls."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return None


def statement_of(mod: LintModule, node: ast.AST) -> ast.AST:
    """The enclosing statement of an expression node."""
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = mod.parent(cur)
    return cur if cur is not None else node


def assigned_names(stmt: ast.AST) -> set:
    """Flat set of Names (re)bound by a statement's targets."""
    out = set()
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


def end_line(node: ast.AST) -> int:
    return getattr(node, "end_lineno", None) or node.lineno


# -- tree discovery -------------------------------------------------------

# directories never scanned (generated/third-party/test-support trees; the
# known-bad fixture corpora must obviously not fail the clean-tree gate)
EXCLUDED_DIRS = {
    "__pycache__", ".git", "work_space", "datasets", "lint_fixtures",
    "torch_lint_fixtures", ".jax_cache", "node_modules",
}

# roots relative to the repo: the port package and the port's scripts (a
# glob); chip_smoke.py and tests/ stay outside, as the JAX linter's tests do:
# the harness signals single ranks on purpose
DEFAULT_ROOTS = (
    "simclr_pytorch_distributed_tpu_torch",
    "scripts/port_*.py",
)


def iter_source_files(repo_root: str, roots=DEFAULT_ROOTS) -> Iterator[str]:
    for root in roots:
        path = os.path.join(repo_root, root)
        if glob.has_magic(root):
            yield from sorted(p for p in glob.glob(path) if os.path.isfile(p))
            continue
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames if d not in EXCLUDED_DIRS
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def load_modules(repo_root: str, roots=DEFAULT_ROOTS) -> List[LintModule]:
    mods = []
    for path in iter_source_files(repo_root, roots):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        mods.append(LintModule(path, rel, source))
    return mods


def load_module(path: str, repo_root: Optional[str] = None) -> LintModule:
    """One-file loader (the fixture tests' entry point)."""
    root = repo_root or os.path.dirname(path)
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        return LintModule(path, rel, f.read())
