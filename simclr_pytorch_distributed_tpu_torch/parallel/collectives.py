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

The ring loss (:func:`ring_supcon_loss`, the JAX package's
``ring_supcon_loss``) does not gather the features: the contrast blocks
travel one hop per ring step through point-to-point sends, and the step
reduces its feature-norm statistics with :func:`global_sum`. The same
gradient contract holds: every process returns the global loss, and its
backward gives the full gradient of that loss with respect to this
process's rows.

``all_gather``, ``all_reduce`` and ``broadcast`` run on CUDA tensors under
gloo too, through host memory; the ring's sends stage CUDA tensors through
the CPU themselves when the backend is not NCCL (:func:`ring_shift`). Every
function here is called by every process in the same order; a failed
collective raises.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

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


def row_ids(owner: int, b: int, views: int = 2, device=None) -> torch.Tensor:
    """Global row ids (int32) of process ``owner``'s ``V * b`` view-major
    rows: ``v * P * b + owner * b + i``."""
    p = world_size()
    i = torch.arange(b, dtype=torch.int32, device=device)
    return torch.cat([v * p * b + owner * b + i for v in range(views)])


def own_row_ids(b: int, views: int = 2, device=None) -> torch.Tensor:
    """Global row ids (int32) of this process's ``V * b`` view-major rows."""
    return row_ids(rank(), b, views, device)


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


class GlobalSum(torch.autograd.Function):
    """:func:`rank_ordered_sum` with the gradient contract of the module
    docstring: the loss ``h(S)``, ``S = sum_p s_p``, is the same on every
    process, so the gradient of this process's ``s_p`` is the incoming
    gradient itself."""

    @staticmethod
    def forward(ctx, value):
        return rank_ordered_sum(value).clone()

    @staticmethod
    def backward(ctx, grad):
        return grad


def global_sum(value: torch.Tensor) -> torch.Tensor:
    """The sum over processes of a small per-process tensor, in rank order,
    differentiable (:class:`GlobalSum`); ``value`` itself without a
    process group."""
    return GlobalSum.apply(value)


def ring_shift(t: torch.Tensor) -> torch.Tensor:
    """One hop around the ring: send ``t`` to rank ``r + 1`` and return
    rank ``r - 1``'s tensor of the same shape. The send and the receive are
    posted together (``batch_isend_irecv``) and both are waited on before
    the call returns, so no hop overlaps the next. A CUDA tensor goes
    through host memory unless the backend is NCCL (gloo sends raw host
    pointers)."""
    p, r = world_size(), rank()
    stage = t.is_cuda and dist.get_backend() != "nccl"
    send = t.detach().cpu() if stage else t.detach().contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (r + 1) % p), dist.P2POp(dist.irecv, recv, (r - 1) % p)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if stage else recv


def _ring_block(anchors, block, rows, cols, ids, temperature):
    """The logits of this process's anchors against one contrast block, with
    the block's self mask and positive mask (equal ``ids``, self excluded)."""
    logits = (anchors @ block.T) / temperature
    self_mask = rows[:, None] == cols[None, :]
    pos_mask = (ids[rows.long()][:, None] == ids[cols.long()][None, :]) & ~self_mask
    return logits, self_mask, pos_mask


class RingSupConLoss(torch.autograd.Function):
    """The mean loss over the global view-major rows from this process's
    rows ``feats`` ``[V * b, D]`` (its two slabs, global ids
    :func:`own_row_ids`) and the class id of every global row ``ids``
    ``[V * B]`` (the sample id for SimCLR, the label for SupCon).

    Forward: ``P`` ring steps. At step ``s`` this process holds the block
    of process ``src = (r - s) mod P``; the block's global ids are
    :func:`row_ids` of ``src``, so they are recomputed rather than sent.
    Each step adds the block's non-self columns to an exact streamed
    log-sum-exp (running max and rescaled sum) and its positives to a sum
    and a count, then passes the block on (``P - 1`` hops). Every process
    returns the rank-ordered mean of the per-process row means.

    Backward: ``P`` ring steps again over the saved ``lse`` and counts.
    With ``G = coeff / T * (softmax - pos / cnt)`` for the held block, the
    anchors' gradient gains ``G @ block`` here, and the block's own
    gradient ``G.T @ anchors`` is added to an accumulator that travels with
    the block (``P - 1`` hops of block and accumulator together); after the
    last step the accumulator is one hop short of its owner, and one more
    hop takes it home. Sums run in a fixed order: the result repeats
    bitwise."""

    @staticmethod
    def forward(ctx, feats, ids, views, temperature, base_temperature):
        p, r = world_size(), rank()
        m = feats.shape[0]
        b = m // views
        rows = row_ids(r, b, views, feats.device)
        run_max = torch.full((m,), -math.inf, dtype=feats.dtype, device=feats.device)
        run_sum = torch.zeros_like(run_max)
        pos = torch.zeros_like(run_max)
        cnt = torch.zeros_like(run_max)
        block = feats
        for s in range(p):
            cols = row_ids((r - s) % p, b, views, feats.device)
            logits, self_mask, pos_mask = _ring_block(feats, block, rows, cols, ids, temperature)
            pos = pos + torch.where(pos_mask, logits, 0.0).sum(dim=1)
            cnt = cnt + pos_mask.sum(dim=1)
            logits = logits.masked_fill(self_mask, -math.inf)
            new_max = torch.maximum(run_max, logits.max(dim=1).values)
            run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
                logits - new_max[:, None]).sum(dim=1)
            run_max = new_max
            if s < p - 1:
                block = ring_shift(block)
        lse = run_max + torch.log(run_sum)
        loss_row = -(temperature / base_temperature) * (pos / cnt - lse)
        ctx.save_for_backward(feats, ids, lse, cnt)
        ctx.views, ctx.temperature, ctx.base_temperature = views, temperature, base_temperature
        return rank_ordered_sum(loss_row.mean()) / p

    @staticmethod
    def backward(ctx, g):
        feats, ids, lse, cnt = ctx.saved_tensors
        p, r = world_size(), rank()
        m = feats.shape[0]
        b = m // ctx.views
        rows = row_ids(r, b, ctx.views, feats.device)
        scale = (ctx.temperature / ctx.base_temperature) / (m * p) / ctx.temperature
        d_anchor = torch.zeros_like(feats)
        block, acc = feats, torch.zeros_like(feats)
        for s in range(p):
            cols = row_ids((r - s) % p, b, ctx.views, feats.device)
            logits, self_mask, pos_mask = _ring_block(
                feats, block, rows, cols, ids, ctx.temperature)
            soft = torch.exp(logits - lse[:, None]).masked_fill(self_mask, 0.0)
            grad = (soft - pos_mask / cnt[:, None]) * scale
            d_anchor = d_anchor + grad @ block
            acc = acc + grad.T @ feats
            if s < p - 1:
                block, acc = ring_shift(torch.cat([block, acc], dim=1)).split(
                    feats.shape[1], dim=1)
        if p > 1:
            acc = ring_shift(acc)  # the accumulator of this process's own block
        return g * (d_anchor + acc), None, None, None, None


def ring_supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
) -> torch.Tensor:
    """The contrastive loss over the global batch by ring (JAX
    ``parallel/collectives.py:36``), without gathering the features:
    ``features`` ``[b, V, D]`` are this process's ``b`` samples of the
    global batch of ``B = P * b``, L2-normalized; ``labels`` the GLOBAL
    ``[B]`` labels for SupCon (:func:`gather_global_labels`), ``None`` for
    SimCLR. Returns the loss over the global batch, the same on every
    process, differentiable with respect to ``features``
    (:class:`RingSupConLoss`). ``contrast_mode`` is 'all'. At ``P = 1``
    the ring is one block and sends nothing.

    The block products are plain matrix products, as in the JAX package,
    where they run outside any Pallas kernel."""
    b, views = features.shape[0], features.shape[1]
    feats = features.transpose(0, 1).reshape(views * b, -1).to(torch.float32).contiguous()
    n_samples = b * world_size()
    if labels is None:
        base = torch.arange(n_samples, dtype=torch.int32, device=features.device)
    else:
        base = labels.reshape(-1).to(device=features.device, dtype=torch.int32)
        if base.shape[0] != n_samples:
            raise ValueError(f"labels must be the global [{n_samples}] vector, "
                             f"got {tuple(labels.shape)}")
    return RingSupConLoss.apply(
        feats, base.repeat(views), views, float(temperature), float(base_temperature)
    )


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
