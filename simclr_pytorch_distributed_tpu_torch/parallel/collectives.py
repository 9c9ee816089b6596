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
function here is called by every process of its group in the same order; a
failed collective raises.

Groups (``--model_parallel N``, ``parallel/mesh.setup_grid``). Every
function takes a ``group``, ``None`` for the world, so at ``N = 1`` each is
the call it was. The train step gives the data-parallel ones the data group
(the ranks that share a model index). Tensor parallelism adds
:func:`gather_channels` over the model group: each rank of a model group
computes its own slice of a sharded layer's output channels, and the next
layer, which reads every channel, all-gathers them. Its backward depends on
who reads the gathered tensor (:class:`GatherChannels`): a sharded layer
gives each rank only its output channels' share of the input's gradient,
so the shares are summed over the model group and each rank keeps its own
channels (a reduce-scatter); a replicated reader (the loss, which every
rank of a model group computes on the same rows) gives each rank the whole
gradient, so each keeps its own channels of it and nothing moves. A
whole tensor that a replicated layer computed and a sharded layer reads
(a ResNet-50 stage of 64 channels before one of 256 at a large ``N``, or
a replicated head's hidden layer before a sharded output) takes
:func:`reduce_grad` in place of the gather: the same sum of shares, and
each rank keeps all of it.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist



def group_size(group=None) -> int:
    """The processes of ``group`` (``None``: the world; 1 without a
    process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank within ``group`` (``None``: the world)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_rank(group, index: int) -> int:
    """The world rank of ``group``'s member ``index``."""
    return index if group is None else dist.get_global_rank(group, index)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every process's ``t`` (same shape and dtype everywhere) in
    ``group``, in group-rank order; ``[t]`` without a process group."""
    if not dist.is_initialized():
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def view_major(parts: List[torch.Tensor], views: int = 2) -> torch.Tensor:
    """Per-rank view-major blocks ``[V * b, ...]`` -> the global view-major
    ``[V * P * b, ...]``: view 1 of every rank, then view 2 of every rank."""
    b = parts[0].shape[0] // views
    return torch.cat([p[v * b:(v + 1) * b] for v in range(views) for p in parts])


def own_rows(rows: torch.Tensor, views: int = 2, group=None) -> torch.Tensor:
    """This process's rows ``[V * b, ...]`` (view-major) of the global
    view-major ``rows`` ``[V * P * b, ...]``: one slab per view."""
    p, r = group_size(group), group_rank(group)
    n = rows.shape[0] // views
    b = n // p
    return torch.cat([rows[v * n + r * b: v * n + (r + 1) * b] for v in range(views)])


def row_ids(owner: int, b: int, views: int = 2, device=None, group=None) -> torch.Tensor:
    """Global row ids (int32) of process ``owner``'s ``V * b`` view-major
    rows: ``v * P * b + owner * b + i``."""
    p = group_size(group)
    i = torch.arange(b, dtype=torch.int32, device=device)
    return torch.cat([v * p * b + owner * b + i for v in range(views)])


def own_row_ids(b: int, views: int = 2, device=None, group=None) -> torch.Tensor:
    """Global row ids (int32) of this process's ``V * b`` view-major rows."""
    return row_ids(group_rank(group), b, views, device, group)


class GatherFeatures(torch.autograd.Function):
    """All-gather of the local view-major rows into the global view-major
    rows; the backward keeps this process's rows of the gradient (module
    docstring, "Gradient scale")."""

    @staticmethod
    def forward(ctx, local, views, group):
        ctx.views, ctx.group = views, group
        return view_major(all_gather(local, group), views)

    @staticmethod
    def backward(ctx, grad):
        return own_rows(grad, ctx.views, ctx.group), None, None


def gather_features(local: torch.Tensor, views: int = 2, group=None) -> torch.Tensor:
    """``[V * b, D]`` local view-major rows -> ``[V * P * b, D]`` global
    view-major rows over ``group``, differentiable (:class:`GatherFeatures`)."""
    return GatherFeatures.apply(local, views, group)


def gather_global_labels(labels_local: torch.Tensor, group=None) -> torch.Tensor:
    """The ``[B]`` global label vector from each process's ``[b]`` slice, in
    sample order (JAX ``parallel/collectives.py:128``): SupCon's positives
    are global, so the labels must be too."""
    return torch.cat(all_gather(labels_local, group))


def rank_ordered_sum(value: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the processes of ``group`` of a per-process tensor,
    added in rank order after an all-gather, so that it repeats bitwise
    whatever the backend's reduction order."""
    parts = all_gather(value, group)
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
    def forward(ctx, value, group):
        return rank_ordered_sum(value, group).clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(value: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the processes of ``group`` of a small per-process
    tensor, in rank order, differentiable (:class:`GlobalSum`); ``value``
    itself without a process group."""
    return GlobalSum.apply(value, group)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """One hop around the ring: send ``t`` to rank ``r + 1`` and return
    rank ``r - 1``'s tensor of the same shape. The send and the receive are
    posted together (``batch_isend_irecv``) and both are waited on before
    the call returns, so no hop overlaps the next. A CUDA tensor goes
    through host memory unless the backend is NCCL (gloo sends raw host
    pointers). Ranks are ``group``'s (``None``: the world)."""
    p, r = group_size(group), group_rank(group)
    stage = t.is_cuda and dist.get_backend(group) != "nccl"
    send = t.detach().cpu() if stage else t.detach().contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, global_rank(group, (r + 1) % p), group),
           dist.P2POp(dist.irecv, recv, global_rank(group, (r - 1) % p), group)]
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
    def forward(ctx, feats, ids, views, temperature, base_temperature, group):
        p, r = group_size(group), group_rank(group)
        m = feats.shape[0]
        b = m // views
        rows = row_ids(r, b, views, feats.device, group)
        run_max = torch.full((m,), -math.inf, dtype=feats.dtype, device=feats.device)
        run_sum = torch.zeros_like(run_max)
        pos = torch.zeros_like(run_max)
        cnt = torch.zeros_like(run_max)
        block = feats
        for s in range(p):
            cols = row_ids((r - s) % p, b, views, feats.device, group)
            logits, self_mask, pos_mask = _ring_block(feats, block, rows, cols, ids, temperature)
            pos = pos + torch.where(pos_mask, logits, 0.0).sum(dim=1)
            cnt = cnt + pos_mask.sum(dim=1)
            logits = logits.masked_fill(self_mask, -math.inf)
            new_max = torch.maximum(run_max, logits.max(dim=1).values)
            run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
                logits - new_max[:, None]).sum(dim=1)
            run_max = new_max
            if s < p - 1:
                block = ring_shift(block, group)
        lse = run_max + torch.log(run_sum)
        loss_row = -(temperature / base_temperature) * (pos / cnt - lse)
        ctx.save_for_backward(feats, ids, lse, cnt)
        ctx.views, ctx.temperature, ctx.base_temperature = views, temperature, base_temperature
        ctx.group = group
        return rank_ordered_sum(loss_row.mean(), group) / p

    @staticmethod
    def backward(ctx, g):
        feats, ids, lse, cnt = ctx.saved_tensors
        group = ctx.group
        p, r = group_size(group), group_rank(group)
        m = feats.shape[0]
        b = m // ctx.views
        rows = row_ids(r, b, ctx.views, feats.device, group)
        scale = (ctx.temperature / ctx.base_temperature) / (m * p) / ctx.temperature
        d_anchor = torch.zeros_like(feats)
        block, acc = feats, torch.zeros_like(feats)
        for s in range(p):
            cols = row_ids((r - s) % p, b, ctx.views, feats.device, group)
            logits, self_mask, pos_mask = _ring_block(
                feats, block, rows, cols, ids, ctx.temperature)
            soft = torch.exp(logits - lse[:, None]).masked_fill(self_mask, 0.0)
            grad = (soft - pos_mask / cnt[:, None]) * scale
            d_anchor = d_anchor + grad @ block
            acc = acc + grad.T @ feats
            if s < p - 1:
                block, acc = ring_shift(torch.cat([block, acc], dim=1), group).split(
                    feats.shape[1], dim=1)
        if p > 1:
            acc = ring_shift(acc, group)  # the accumulator of this process's own block
        return g * (d_anchor + acc), None, None, None, None, None


def ring_supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
    group=None,
) -> torch.Tensor:
    """The contrastive loss over the global batch by ring (JAX
    ``parallel/collectives.py:36``), without gathering the features:
    ``features`` ``[b, V, D]`` are this process's ``b`` samples of the
    global batch of ``B = P * b``, L2-normalized; ``labels`` the GLOBAL
    ``[B]`` labels for SupCon (:func:`gather_global_labels`), ``None`` for
    SimCLR. Returns the loss over the global batch, the same on every
    process, differentiable with respect to ``features``
    (:class:`RingSupConLoss`). ``contrast_mode`` is 'all'. At ``P = 1``
    the ring is one block and sends nothing. ``P`` is ``group``'s size
    (``None``: the world; under a grid the data group).

    The block products are plain matrix products, as in the JAX package,
    where they run outside any Pallas kernel."""
    b, views = features.shape[0], features.shape[1]
    feats = features.transpose(0, 1).reshape(views * b, -1).to(torch.float32).contiguous()
    n_samples = b * group_size(group)
    if labels is None:
        base = torch.arange(n_samples, dtype=torch.int32, device=features.device)
    else:
        base = labels.reshape(-1).to(device=features.device, dtype=torch.int32)
        if base.shape[0] != n_samples:
            raise ValueError(f"labels must be the global [{n_samples}] vector, "
                             f"got {tuple(labels.shape)}")
    return RingSupConLoss.apply(
        feats, base.repeat(views), views, float(temperature), float(base_temperature), group
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
def mean_gradients(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Replace every parameter's gradient with its mean over the processes
    of ``group`` (``None``: the world): one all-reduce over a flat buffer
    per dtype, then a division by ``P`` (DDP's gradient mean, without its
    hooks). A parameter without a gradient has none on every process (the
    same graph runs everywhere). A tensor-parallel shard's gradient is
    averaged over the data group with the others: each rank holds the whole
    gradient of its own channels."""
    if not dist.is_initialized():
        return
    p = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(p)

    _through_flat([q.grad for q in params if q.grad is not None], mean)


def _float_tensors(module: torch.nn.Module, parameters: bool) -> List[torch.Tensor]:
    tensors = [b for b in module.buffers() if b.is_floating_point()]
    if parameters:
        tensors += [q.data for q in module.parameters()]
    return tensors


@torch.no_grad()
def broadcast_from_rank0(module: torch.nn.Module, parameters: bool = True,
                         group=None) -> None:
    """Copy ``group``'s first process's floating-point buffers (and, with
    ``parameters``, its parameters) into every process of ``group``
    (``None``: the world, from rank 0): one broadcast of a flat buffer per
    dtype. The initial weights, and after each step without ``--syncBN``
    the BN running buffers, which follow rank 0 as under DDP's
    ``broadcast_buffers=True`` (JAX ``models/norm.py:190-197``); under a
    grid over the data group, whose first process is data slice 0, since
    each model index holds its own shards."""
    if group_size(group) == 1:
        return
    src = global_rank(group, 0)
    _through_flat(_float_tensors(module, parameters),
                  lambda flat: dist.broadcast(flat, src=src, group=group))


# -- tensor parallelism over the model group ---------------------------------

def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its channel dim (1) moved last: a view, contiguous for the
    activations the encoder keeps channels-last, a copy otherwise."""
    return x.movedim(1, -1).contiguous()


def reduce_scatter_channels(grad: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``grad`` ``[B, C, ...]``, of which this
    process keeps its own ``C / N`` channels: one ``reduce_scatter``. NCCL
    takes it, and so does gloo, on the CPU and on CUDA tensors, in the
    builds the port runs on (the ``tensor_parallel`` phase of
    ``chip_smoke.py`` runs it on the card's gloo); a build without it
    raises here."""
    n, m = dist.get_world_size(group), dist.get_rank(group)
    chunks = [c.contiguous() for c in _channels_last(grad).chunk(n, dim=-1)]
    out = torch.empty_like(chunks[m])
    dist.reduce_scatter(out, chunks, group=group)
    return out.movedim(-1, 1)


class GatherChannels(torch.autograd.Function):
    """All-gather of this process's channel slice ``[B, C / N, ...]`` over
    the model group into ``[B, C, ...]``, in model-index order. The backward
    (module docstring, "Groups"): with ``partial`` (a sharded layer reads
    the result) the gradient is summed over the group and this process
    keeps its channels (:func:`reduce_scatter_channels`); without it (a
    replicated reader) this process keeps its channels of its own gradient.
    The result keeps ``x``'s memory format: channels-last activations
    gather and scatter with no transposing copy."""

    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial = group, partial
        parts = all_gather(x.movedim(1, -1), group)
        return torch.cat(parts, dim=-1).movedim(-1, 1)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            return reduce_scatter_channels(grad, ctx.group), None, None
        n, m = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=1)[m], None, None


class ReduceGrad(torch.autograd.Function):
    """The identity forward of a whole tensor that a sharded layer reads;
    its backward sums the gradient over the model group (one all-reduce),
    since that layer gives each process only its output channels' share of
    the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over the model ``group``
    (:class:`ReduceGrad`)."""
    return ReduceGrad.apply(x, group)


def gather_channels(x: torch.Tensor, group, partial: bool) -> torch.Tensor:
    """``x``'s channel slices of the model ``group``, whole and
    differentiable (:class:`GatherChannels`); ``partial``: a sharded layer
    reads the result (its gradient is this rank's share only)."""
    return GatherChannels.apply(x, group, partial)
