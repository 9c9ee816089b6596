"""Fused SupCon / SimCLR loss: hand-written CUDA kernels and their plain forms.

The kernels (``csrc/fused_supcon_loss.cu``) replace the JAX package's Pallas
pair in ``simclr_pytorch_distributed_tpu/ops/pallas_loss.py``:
``supcon_fwd_kernel`` replaces ``_fwd_kernel`` and ``supcon_bwd_kernel``
replaces ``_bwd_kernel``. The forward streams column tiles of ``F·Fᵀ/τ``
with an online log-sum-exp and keeps per row only ``loss_row``, ``lse`` and
the positive count; the backward recomputes each logits tile from those and
accumulates ``dF`` with no O(N²) residual. Each row tile's column walk is
split over a cluster of CTAs whose partials meet in distributed shared
memory in a fixed order, so both kernels are bitwise repeatable and need
no workspace. The source file states what bounds them on the H100 and what
their design does about it.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(:func:`fused_rows_reference`, :func:`fused_bwd_reference`); a CUDA tensor
launches the kernel or raises; any other device raises. There is no
fallback from the kernel to the plain version.

``fwd_launches`` / ``bwd_launches`` count kernel launches (only the CUDA
branch adds to them), so a run can show that its main path went through the
kernels.

The sharded form (:func:`fused_sharded_supcon_loss`, JAX
``ops/pallas_loss.py:298-357, :417``) runs the same two kernels over a
process group: each process's anchor rows against the all-gathered global
columns, with the rows' global ids. The backward kernel returns the full
gradient of each anchor row (its row and its column terms), so the
backward needs only the O(N) ``lse``/``cnt`` of every row and no exchange
of gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from simclr_pytorch_distributed_tpu_torch.ops import native
from simclr_pytorch_distributed_tpu_torch.parallel import collectives

fwd_launches = 0
bwd_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = native.load("fused_supcon_loss")
    lib.supcon_fwd.argtypes = [_P] * 9 + [_I, _I, _I, _F, _F, _P]
    lib.supcon_fwd.restype = _I
    lib.supcon_bwd.argtypes = [_P] * 11 + [_I, _I, _I, _F, _F, _P]
    lib.supcon_bwd.restype = _I
    return lib


def _check_inputs(frow, fcol, idr, idc, grow, gcol) -> Tuple[int, int, int]:
    if frow.dim() != 2 or fcol.dim() != 2 or frow.shape[1] != fcol.shape[1]:
        raise ValueError(
            f"frow/fcol must be [nr, D] and [nc, D], got "
            f"{tuple(frow.shape)} and {tuple(fcol.shape)}"
        )
    nr, d = frow.shape
    nc = fcol.shape[0]
    if nr < 1 or nc < 2 or d < 1:
        raise ValueError(f"fused loss needs nr >= 1, nc >= 2, D >= 1; got {nr}, {nc}, {d}")
    native.check_tensor("frow", frow, torch.float32, (nr, d))
    native.check_tensor("fcol", fcol, torch.float32, (nc, d))
    native.check_tensor("idr", idr, torch.int32, (nr,))
    native.check_tensor("idc", idc, torch.int32, (nc,))
    native.check_tensor("grow", grow, torch.int32, (nr,))
    native.check_tensor("gcol", gcol, torch.int32, (nc,))
    return nr, nc, d


def fused_rows_reference(frow, fcol, idr, idc, grow, gcol, temperature, base_temperature):
    """Plain form of the forward kernel: ``(loss_row, lse, cnt)``, each ``[nr]``."""
    logits = (frow @ fcol.T) * (1.0 / temperature)
    self_mask = grow[:, None] == gcol[None, :]
    pos = (idr[:, None] == idc[None, :]) & ~self_mask
    lse = torch.logsumexp(logits.masked_fill(self_mask, float("-inf")), dim=1)
    cnt = pos.sum(dim=1).to(torch.float32)
    pos_sum = torch.where(pos, logits, torch.zeros_like(logits)).sum(dim=1)
    loss_row = -(temperature / base_temperature) * (pos_sum / cnt - lse)
    return loss_row, lse, cnt


def fused_bwd_reference(
    frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c, temperature, coeff
):
    """Plain form of the backward kernel: ``dF`` ``[nr, D]`` of the anchor rows."""
    inv_temp = 1.0 / temperature
    logits = (frow @ fcol.T) * inv_temp
    self_mask = grow[:, None] == gcol[None, :]
    pos = ((idr[:, None] == idc[None, :]) & ~self_mask).to(torch.float32)
    zero = torch.zeros_like(logits)
    sm_i = torch.where(self_mask, zero, torch.exp(logits - lse_r[:, None]))
    sm_j = torch.where(self_mask, zero, torch.exp(logits - lse_c[None, :]))
    h = (sm_i - pos / cnt_r[:, None]) + (sm_j - pos / cnt_c[None, :])
    return (h @ fcol) * (coeff * inv_temp)


def fused_rows(frow, fcol, idr, idc, grow, gcol, temperature, base_temperature):
    """Per-anchor-row ``(loss_row, lse, cnt)`` of rows ``frow`` against
    columns ``fcol`` (``frow is fcol`` on one device). Launches
    ``supcon_fwd_kernel`` for CUDA tensors."""
    global fwd_launches
    if native.on_cpu(frow, fcol, idr, idc, grow, gcol):
        return fused_rows_reference(
            frow, fcol, idr, idc, grow, gcol, temperature, base_temperature
        )
    nr, nc, d = _check_inputs(frow, fcol, idr, idc, grow, gcol)
    lib = _library()
    loss_row, lse, cnt = torch.empty((3, nr), dtype=torch.float32, device=frow.device)
    stream = torch.cuda.current_stream(frow.device).cuda_stream
    code = lib.supcon_fwd(
        frow.data_ptr(), fcol.data_ptr(), idr.data_ptr(), idc.data_ptr(),
        grow.data_ptr(), gcol.data_ptr(),
        loss_row.data_ptr(), lse.data_ptr(), cnt.data_ptr(),
        nr, nc, d, 1.0 / temperature, temperature / base_temperature, stream,
    )
    native.raise_on_error(code, "supcon_fwd_kernel")
    fwd_launches += 1
    return loss_row, lse, cnt


def fused_bwd(frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c, temperature, coeff):
    """``dF`` of the anchor rows; launches ``supcon_bwd_kernel`` for CUDA
    tensors. ``lse_*``/``cnt_*`` are the forward's per-row outputs for the
    rows and for the columns."""
    global bwd_launches
    tensors = (frow, fcol, idr, idc, grow, gcol, lse_r, lse_c, cnt_r, cnt_c)
    if native.on_cpu(*tensors):
        return fused_bwd_reference(*tensors, temperature, coeff)
    nr, nc, d = _check_inputs(frow, fcol, idr, idc, grow, gcol)
    for name, t, n in (("lse_r", lse_r, nr), ("lse_c", lse_c, nc),
                       ("cnt_r", cnt_r, nr), ("cnt_c", cnt_c, nc)):
        native.check_tensor(name, t, torch.float32, (n,))
    lib = _library()
    dfeat = torch.empty((nr, d), dtype=torch.float32, device=frow.device)
    stream = torch.cuda.current_stream(frow.device).cuda_stream
    code = lib.supcon_bwd(
        *(t.data_ptr() for t in tensors), dfeat.data_ptr(),
        nr, nc, d, 1.0 / temperature, coeff, stream,
    )
    native.raise_on_error(code, "supcon_bwd_kernel")
    bwd_launches += 1
    return dfeat


class FusedSupConLoss(torch.autograd.Function):
    """Mean NT-Xent/SupCon loss over view-major rows ``feats`` ``[N, D]``
    with sample ids ``ids`` ``[N]``; the backward is the fused kernel."""

    @staticmethod
    def forward(ctx, feats, ids, temperature, base_temperature):
        gid = torch.arange(feats.shape[0], dtype=torch.int32, device=feats.device)
        loss_row, lse, cnt = fused_rows(
            feats, feats, ids, ids, gid, gid, temperature, base_temperature
        )
        ctx.save_for_backward(feats, ids, gid, lse, cnt)
        ctx.temperature = temperature
        ctx.base_temperature = base_temperature
        return loss_row.mean()

    @staticmethod
    def backward(ctx, g):
        feats, ids, gid, lse, cnt = ctx.saved_tensors
        coeff = (ctx.temperature / ctx.base_temperature) / feats.shape[0]
        dfeats = fused_bwd(
            feats, feats, ids, ids, gid, gid, lse, lse, cnt, cnt,
            ctx.temperature, coeff,
        )
        return g * dfeats, None, None, None


def fused_supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
) -> torch.Tensor:
    """Drop-in for ``supcon_loss(..., contrast_mode='all')`` on
    ``[B, V, D]`` L2-normalized features; ``labels`` ``[B]`` for SupCon,
    ``None`` for SimCLR. Differentiable with respect to ``features``."""
    batch, n_views = features.shape[0], features.shape[1]
    n = batch * n_views
    feats = features.transpose(0, 1).reshape(n, -1).to(torch.float32).contiguous()
    if labels is None:
        base = torch.arange(batch, dtype=torch.int32, device=features.device)
    else:
        base = labels.reshape(-1).to(device=features.device, dtype=torch.int32)
    ids = base.repeat(n_views)
    return FusedSupConLoss.apply(
        feats, ids, float(temperature), float(base_temperature)
    )


class FusedShardedSupConLoss(torch.autograd.Function):
    """The mean loss over the global view-major rows, from this process's
    rows ``feats`` ``[V * b, D]`` (view-major over its ``b`` samples) with
    global row ids ``grow`` and the global sample ids ``ids`` ``[V * B]``.
    Every process returns the same value; the backward gives the gradient
    of that value with respect to this process's rows."""

    @staticmethod
    def forward(ctx, feats, ids, grow, views, temperature, base_temperature, group):
        cols = collectives.view_major(collectives.all_gather(feats, group), views)
        gcol = torch.arange(cols.shape[0], dtype=torch.int32, device=feats.device)
        idr = ids[grow.long()]
        loss_row, lse, cnt = fused_rows(
            feats, cols, idr, ids, grow, gcol, temperature, base_temperature
        )
        n_procs = cols.shape[0] // feats.shape[0]
        loss = collectives.rank_ordered_sum(loss_row.mean(), group) / n_procs
        ctx.save_for_backward(feats, cols, idr, ids, grow, gcol, lse, cnt)
        ctx.views, ctx.group = views, group
        ctx.temperature = temperature
        ctx.base_temperature = base_temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        feats, cols, idr, ids, grow, gcol, lse, cnt = ctx.saved_tensors
        # the column statistics: every process's (lse, cnt), one gather
        stats = collectives.view_major(
            collectives.all_gather(torch.stack([lse, cnt], dim=1), ctx.group), ctx.views
        )
        lse_c, cnt_c = stats[:, 0].contiguous(), stats[:, 1].contiguous()
        coeff = (ctx.temperature / ctx.base_temperature) / cols.shape[0]
        dfeats = fused_bwd(
            feats, cols, idr, ids, grow, gcol, lse, lse_c, cnt, cnt_c,
            ctx.temperature, coeff,
        )
        return g * dfeats, None, None, None, None, None, None


def fused_sharded_supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
    group=None,
) -> torch.Tensor:
    """:func:`fused_supcon_loss` over the process group: ``features``
    ``[b, V, D]`` are this process's ``b`` samples of the global batch of
    ``B = P * b`` (process ``r`` holds samples ``r * b .. (r + 1) * b - 1``),
    L2-normalized; ``labels`` the GLOBAL ``[B]`` labels for SupCon,
    ``None`` for SimCLR. Returns the loss over the global batch, the same
    on every process, differentiable with respect to ``features``.

    This process's rows are two slabs of the global view-major matrix
    (ids ``v * B + r * b + i``); the kernels take them as they are. ``P``
    and ``r`` are ``group``'s (``None``: the world; under ``--model_parallel``
    the data group, whose ranks hold different rows)."""
    b, views = features.shape[0], features.shape[1]
    feats = features.transpose(0, 1).reshape(views * b, -1).to(torch.float32).contiguous()
    n_samples = b * collectives.group_size(group)
    if labels is None:
        base = torch.arange(n_samples, dtype=torch.int32, device=features.device)
    else:
        base = labels.reshape(-1).to(device=features.device, dtype=torch.int32)
        if base.shape[0] != n_samples:
            raise ValueError(f"labels must be the global [{n_samples}] vector, "
                             f"got {tuple(labels.shape)}")
    grow = collectives.own_row_ids(b, views, device=features.device, group=group)
    return FusedShardedSupConLoss.apply(
        feats, base.repeat(views), grow, views, float(temperature), float(base_temperature),
        group,
    )
