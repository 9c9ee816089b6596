"""Collective classification + the module-level call graph, for the port.

The port's collectives are the calls whose SCHEDULE must match across the
processes of their group: a process that skips one while its peers enter
it hangs them until the collective's timeout. They are ``torch.distributed``
calls, the port's wrappers of them (``parallel/collectives.py``,
``parallel/mesh.py``, with the tensor-parallel grid's groups and channel
gathers), the autograd Functions whose forward or backward runs one
(``SyncBatchNorm.apply`` and the like), the boundary-only preemption vote
(``preempt.requested_global``), the telemetry boundary exchange, the
placement agreement and the checkpoint save (a gather of the
tensor-parallel shards). Classification is by TERMINAL name
(``core.call_name``), as in the JAX package's linter, except
``<Function>.apply``, whose terminal name is every autograd Function's:
only the classes in :data:`COLLECTIVE_FUNCTIONS` count. Reachability
closes over same-module bare-name calls (a driver's local ``submit``
helper reaches the flush boundary inside it).

:func:`reaching_functions` is the JAX package's fixed point, unchanged.
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from simclr_pytorch_distributed_tpu_torch.analysis.core import (
    LintModule,
    call_name,
)

COLLECTIVE_CALLS = frozenset({
    # torch.distributed
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "barrier", "all_gather_object",
    "broadcast_object_list", "gather_object", "scatter_object_list",
    "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "new_group", "init_process_group", "destroy_process_group",
    # parallel/collectives.py
    "gather_features", "gather_global_labels", "rank_ordered_sum", "global_sum",
    "ring_shift", "ring_supcon_loss", "mean_gradients", "broadcast_from_rank0",
    "reduce_scatter_channels", "gather_channels", "reduce_grad",
    # parallel/mesh.py
    "broadcast_from_main", "sync_processes", "setup_distributed",
    "teardown_distributed", "setup_grid", "whole_norms",
    # ops/fused_loss.py: the sharded form gathers the rows and the statistics
    "fused_sharded_supcon_loss",
    # utils/preempt.py: the boundary-only vote
    "requested_global",
    # utils/telemetry.py: the boundary exchange (the failure-code gather)
    "check_failures_global", "drain_global", "flush_boundary", "finish_epoch",
    # data/device_store.py: the placement ladder's agreement
    "_agree_across_processes", "make_store",
    # utils/checkpoint.py: a save gathers the tensor-parallel shards
    "save_checkpoint", "whole_snapshot",
})

# autograd Functions whose forward or backward runs a collective: their
# ``.apply`` is a collective call
COLLECTIVE_FUNCTIONS = frozenset({
    "SyncBatchNorm", "GatherFeatures", "GlobalSum", "RingSupConLoss",
    "FusedShardedSupConLoss", "GatherChannels", "ReduceGrad",
})

# Calls whose value is PROCESS-DEPENDENT (differs across processes): a
# branch on one selects different collective schedules on different ranks.
PROCESS_DEPENDENT_CALLS = frozenset({
    "rank", "get_rank", "is_main_process", "local_rank", "data_index",
    "model_index", "group_rank",
})

# the environment variables that name a process
PROCESS_DEPENDENT_ENV = frozenset({"RANK", "LOCAL_RANK"})

# Process-UNIFORM runtime queries (the same value everywhere), listed so
# the classifier's intent is explicit: ``if world_size() == 1: return`` is
# the port's single-process short-circuit, not a hazard.
PROCESS_UNIFORM_CALLS = frozenset({
    "world_size", "get_world_size", "is_distributed", "is_initialized",
    "data_parallel", "model_parallel", "data_distributed", "group_size",
})


def reaching_functions(mod: LintModule, targets: frozenset) -> Set[str]:
    """Names of functions in ``mod`` that (transitively, via same-module
    bare-name calls) make a call whose terminal name is in ``targets``.

    The fixed point runs over ALL function defs in the module, module-level
    and nested alike, keyed by bare name — the resolution a same-module
    call site actually uses.
    """
    calls: Dict[str, Set[str]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            called = set()
            for sub in ast.walk(node):
                name = call_name(sub)
                if name:
                    called.add(name)
            # a name defined twice keeps the union (conservative)
            calls.setdefault(node.name, set()).update(called)

    reaching: Set[str] = {
        name for name, called in calls.items() if called & targets
    }
    changed = True
    while changed:
        changed = False
        for name, called in calls.items():
            if name not in reaching and called & reaching:
                reaching.add(name)
                changed = True
    return reaching


def _collective_apply(node: ast.AST) -> bool:
    """``SyncBatchNorm.apply(...)`` and the other Functions of
    :data:`COLLECTIVE_FUNCTIONS`."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "apply"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in COLLECTIVE_FUNCTIONS
    )


def collective_reachers(mod: LintModule) -> Set[str]:
    """Functions reaching a collective: by terminal name, or through a
    collective Function's ``.apply`` (the seeds), then closed over
    same-module bare-name calls."""
    reaching = reaching_functions(mod, COLLECTIVE_CALLS)
    seeds = {
        node.name for node in ast.walk(mod.tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and any(_collective_apply(sub) for sub in ast.walk(node))
    }
    if seeds - reaching:
        reaching |= reaching_functions(mod, frozenset(reaching | seeds)) | seeds
    return reaching


def is_collective_call(node: ast.AST, reachers: Set[str]) -> bool:
    """Does this Call node enter a collective (directly or via a
    same-module function known to reach one)?"""
    name = call_name(node)
    if name is None:
        return False
    if name in COLLECTIVE_CALLS or _collective_apply(node):
        return True
    # transitive resolution only for BARE-name calls: attribute calls
    # resolve to other objects' methods, which terminal-name matching
    # already covered above
    return isinstance(node.func, ast.Name) and name in reachers


def _reads_process_env(node: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("LOCAL_RANK")``,
    ``os.getenv("RANK")``."""
    key = None
    if isinstance(node, ast.Subscript):
        key = node.slice
    elif isinstance(node, ast.Call) and call_name(node) in ("get", "getenv") and node.args:
        key = node.args[0]
    return isinstance(key, ast.Constant) and key.value in PROCESS_DEPENDENT_ENV


def expr_is_process_dependent(expr: ast.AST) -> bool:
    """Does evaluating ``expr`` read a per-process value? (A call of
    :data:`PROCESS_DEPENDENT_CALLS` anywhere inside, bare or as an
    attribute, or a read of ``RANK``/``LOCAL_RANK`` from the environment;
    ``world_size()`` and the grid's sizes do not.)"""
    for node in ast.walk(expr):
        if call_name(node) in PROCESS_DEPENDENT_CALLS or _reads_process_env(node):
            return True
    return False


def flush_boundary_reachers(mod: LintModule) -> Set[str]:
    """Functions reaching the telemetry flush boundary — the hot-loop
    rule's loop marker (rule_hotloop)."""
    return reaching_functions(mod, frozenset({"flush_boundary"}))
