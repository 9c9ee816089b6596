"""The collectives of the data-parallel train step.

Each process forwards its own slice of the global batch. Its projection
features are view-major over that slice, ``[v1 of its b samples; v2 of its
b samples]``; :func:`gather_features` all-gathers them and reassembles the
global batch view-major, ``[v1 of every rank; v2 of every rank]``, the
layout the reference builds for two ranks (``main_supcon.py:276-279``) and
the JAX package's step builds for any count (SURVEY §2.2, reference bug 3).

Gradient scale. Every process computes the same global loss from the
gathered rows, so the partial derivative of that loss with respect to its
OWN rows is complete on that process: the gather's backward keeps this
process's rows of the incoming gradient and adds nothing from its peers.
The encoder's backward then gives each process the share of the parameter
gradient that flows through its rows, and the shares sum to the exact
global gradient. :func:`mean_gradients` averages them (one all-reduce, as
DDP's), so the train step scales its loss by ``P / grad_div`` to apply the
exact global gradient over ``grad_div``, the JAX package's rule
(``train/supcon_step.py``).

Only ``all_gather``, ``all_reduce`` and ``broadcast`` are used: gloo runs
all three on CUDA tensors too, through host memory. Every function here is
called by every process in the same order; a failed collective raises.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

from simclr_pytorch_distributed_tpu_torch.parallel.mesh import rank, world_size


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (same shape and dtype everywhere), in rank
    order; ``[t]`` without a process group."""
    if not dist.is_initialized():
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return parts


def view_major(parts: List[torch.Tensor], views: int = 2) -> torch.Tensor:
    """Per-rank view-major blocks ``[V * b, ...]`` -> the global view-major
    ``[V * P * b, ...]``: view 1 of every rank, then view 2 of every rank."""
    b = parts[0].shape[0] // views
    return torch.cat([p[v * b:(v + 1) * b] for v in range(views) for p in parts])


def own_rows(rows: torch.Tensor, views: int = 2) -> torch.Tensor:
    """This process's rows ``[V * b, ...]`` (view-major) of the global
    view-major ``rows`` ``[V * P * b, ...]``: one slab per view."""
    p, r = world_size(), rank()
    n = rows.shape[0] // views
    b = n // p
    return torch.cat([rows[v * n + r * b: v * n + (r + 1) * b] for v in range(views)])


def own_row_ids(b: int, views: int = 2, device=None) -> torch.Tensor:
    """Global row ids (int32) of this process's ``V * b`` view-major rows:
    ``v * P * b + rank * b + i``."""
    p, r = world_size(), rank()
    i = torch.arange(b, dtype=torch.int32, device=device)
    return torch.cat([v * p * b + r * b + i for v in range(views)])


class GatherFeatures(torch.autograd.Function):
    """All-gather of the local view-major rows into the global view-major
    rows; the backward keeps this process's rows of the gradient (module
    docstring, "Gradient scale")."""

    @staticmethod
    def forward(ctx, local, views):
        ctx.views = views
        return view_major(all_gather(local), views)

    @staticmethod
    def backward(ctx, grad):
        return own_rows(grad, ctx.views), None


def gather_features(local: torch.Tensor, views: int = 2) -> torch.Tensor:
    """``[V * b, D]`` local view-major rows -> ``[V * P * b, D]`` global
    view-major rows, differentiable (:class:`GatherFeatures`)."""
    return GatherFeatures.apply(local, views)


def gather_global_labels(labels_local: torch.Tensor) -> torch.Tensor:
    """The ``[B]`` global label vector from each process's ``[b]`` slice, in
    sample order (JAX ``parallel/collectives.py:128``): SupCon's positives
    are global, so the labels must be too."""
    return torch.cat(all_gather(labels_local))


def rank_ordered_sum(value: torch.Tensor) -> torch.Tensor:
    """The sum over processes of a per-process tensor, added in rank order
    after an all-gather, so that it repeats bitwise whatever the backend's
    reduction order."""
    parts = all_gather(value)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _through_flat(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on one flat buffer per dtype holding
    ``tensors``, then copy the result back into them."""
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def mean_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every parameter's gradient with its mean over the processes:
    one all-reduce over a flat buffer per dtype, then a division by ``P``
    (DDP's gradient mean, without its hooks). A parameter without a
    gradient has none on every process (the same graph runs everywhere)."""
    if not dist.is_initialized():
        return
    p = dist.get_world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(p)

    _through_flat([q.grad for q in params if q.grad is not None], mean)


def _float_tensors(module: torch.nn.Module, parameters: bool) -> List[torch.Tensor]:
    tensors = [b for b in module.buffers() if b.is_floating_point()]
    if parameters:
        tensors += [q.data for q in module.parameters()]
    return tensors


@torch.no_grad()
def broadcast_from_rank0(module: torch.nn.Module, parameters: bool = True) -> None:
    """Copy rank 0's floating-point buffers (and, with ``parameters``, its
    parameters) into every process's ``module``: one broadcast of a flat
    buffer per dtype. The initial weights, and after each step without
    ``--syncBN`` the BN running buffers, which follow rank 0 as under DDP's
    ``broadcast_buffers=True`` (JAX ``models/norm.py:190-197``)."""
    if world_size() == 1:
        return
    _through_flat(_float_tensors(module, parameters), lambda flat: dist.broadcast(flat, src=0))
