"""Top-k accuracy, the embedding covariance, the host-side meter and the
device-side metric ring.

``topk_accuracy`` is the reference ``accuracy()`` (``util.py:37-51``):
percent of targets found in the top-k predictions, one value per k.
``topk_correct`` gives the counts instead, which sum over batches (JAX
``ops/metrics.py:51``). ``torch.topk`` and ``jax.lax.top_k`` may order
equal logits differently, so the two packages agree where no two of a
row's top logits tie. A k above the number of classes counts every class
(top-5 of a 3-class probe is 100%), where the JAX function raises.

:class:`MetricRing` (JAX ``ops/metrics.py:84``) is the drivers' per-step
metric store: a ``[window, width]`` fp32 tensor on the device that each
step writes one row of, and that a flush copies to the host once per
window (``utils/telemetry.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def _hits(logits: torch.Tensor, labels: torch.Tensor, maxk: int) -> torch.Tensor:
    """``[batch, maxk]``: whether the j-th ranked prediction is the label."""
    pred = torch.topk(logits, min(maxk, logits.shape[1]), dim=1).indices
    return pred == labels.reshape(-1, 1).to(pred.dtype)


def topk_accuracy(
    output: torch.Tensor, target: torch.Tensor, topk: Sequence[int] = (1,)
) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent, one 0-dim tensor per k (JAX
    ``ops/metrics.py:18``)."""
    hit = _hits(output, target, max(topk))
    batch_size = target.shape[0]
    return tuple(hit[:, :k].sum().to(torch.float32) * (100.0 / batch_size) for k in topk)


def topk_correct(
    logits: torch.Tensor, labels: torch.Tensor, ks: Sequence[int] = (1, 5)
) -> Dict[int, torch.Tensor]:
    """Top-k correct counts per k (int64 0-dim tensors), summable across
    batches."""
    hit = _hits(logits, labels, max(ks))
    return {k: hit[:, :k].any(dim=1).sum() for k in ks}


def embedding_covariance(emb: torch.Tensor, center: bool = False,
                         ddof: int = 0) -> torch.Tensor:
    """``[D, D]`` (co)variance of an ``[N, D]`` embedding batch (JAX
    ``ops/metrics.py:34``); the health diagnostics take the uncentered
    second moment (``center=False, ddof=0``)."""
    if center:
        emb = emb - emb.mean(dim=0, keepdim=True)
    return emb.T @ emb / (emb.shape[0] - ddof)


class AverageMeter:
    """Running value/average meter (reference ``util.py:19-34``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Snapshot(NamedTuple):
    """A flush's copy of the ring: ``tensor`` (a clone taken on the
    compute stream) and ``ready``, a CUDA event recorded after the clone
    (``None`` on the CPU)."""

    tensor: torch.Tensor
    ready: Optional["torch.cuda.Event"]


class MetricRing:
    """Device-side ``[window, width]`` fp32 metric ring and its host
    bookkeeping (JAX ``ops/metrics.py:84``).

    Columns are the scalar ``keys`` in sorted order, then each of
    ``blocks`` (name -> shape, sorted by name) flattened: a tensor-valued
    metric that rides the same transfer (the health step's ``[D, D]``
    covariance). :meth:`write` puts a step's metrics into row ``step %
    window`` with indexing ops on the device; ``step`` is the host's int,
    so no scalar goes to the device and nothing waits. A block missing from
    a step's metrics is written as NaN. :meth:`append`/:meth:`take_window`
    keep the host's list of the rows pending a flush, and a pending list
    longer than the window raises.

    A flush is one :meth:`snapshot` on the main thread (a clone on the
    compute stream, then an event) and one :meth:`resolve`, on whichever
    thread runs the flush: ONE device-to-host copy of the snapshot through
    ``device_get``. The default copies on a side stream that waits only on
    the snapshot's event, into a pinned host buffer, so the copy does not
    queue behind the steps dispatched after the snapshot. ``device_get``
    is injectable (it receives the :class:`Snapshot` and returns an array),
    and ``transfers`` counts the copies.
    """

    def __init__(
        self,
        window: int,
        keys: Sequence[str],
        device_get: Optional[Callable[[Snapshot], np.ndarray]] = None,
        blocks: Optional[Mapping[str, Tuple[int, ...]]] = None,
    ) -> None:
        if window <= 0:
            raise ValueError(f"ring window must be positive, got {window}")
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate metric keys: {sorted(keys)}")
        blocks = dict(blocks or {})
        if set(blocks) & set(keys):
            raise ValueError(f"block names {sorted(blocks)} collide with metric keys")
        self.window = int(window)
        self.keys = tuple(sorted(keys))
        self.blocks: Dict[str, Tuple[int, ...]] = {
            name: tuple(int(d) for d in blocks[name]) for name in sorted(blocks)}
        offset = len(self.keys)
        self._spans: Dict[str, Tuple[int, int]] = {}
        for name, shape in self.blocks.items():
            size = math.prod(shape)
            self._spans[name] = (offset, offset + size)
            offset += size
        self.width = offset
        self._device_get = device_get if device_get is not None else self.fetch
        self._pending = []
        self.transfers = 0
        self._host: Optional[torch.Tensor] = None
        self._stream = None

    def init_buffer(self, device=None) -> torch.Tensor:
        """A fresh (zero) ring on ``device``; one per epoch, never
        checkpointed. On a CUDA device this also makes, once, the pinned
        host buffer and the side stream the default transfer uses."""
        device = torch.device("cpu") if device is None else torch.device(device)
        buf = torch.zeros((self.window, self.width), dtype=torch.float32, device=device)
        if device.type == "cuda" and self._host is None:
            self._host = torch.empty((self.window, self.width), dtype=torch.float32,
                                     pin_memory=True)
            self._stream = torch.cuda.Stream(device)
        return buf

    def write(self, ring: torch.Tensor, metrics: Mapping[str, torch.Tensor],
              step: int) -> torch.Tensor:
        """Write ``metrics`` (0-dim tensors for the keys, one tensor per
        block given) into row ``step % window`` of ``ring``, in place; no
        host sync. Raises when the keys are not the ring's."""
        scalars = sorted(k for k in metrics if k not in self.blocks)
        if tuple(scalars) != self.keys:
            raise ValueError(f"metric keys {scalars} != ring keys {list(self.keys)}")
        slot = int(step) % self.window
        row = torch.stack([metrics[k].reshape(()).to(torch.float32) for k in self.keys])
        ring[slot, :len(self.keys)].copy_(row)
        for name, (lo, hi) in self._spans.items():
            if name in metrics:
                ring[slot, lo:hi].copy_(metrics[name].reshape(-1))
            else:
                ring[slot, lo:hi].fill_(float("nan"))
        return ring

    def append(self, info, step: int) -> None:
        """Record that the step just dispatched wrote slot ``step % window``."""
        if len(self._pending) >= self.window:
            raise RuntimeError(
                f"metric ring overflow: {len(self._pending)} steps pending in "
                f"a window of {self.window} — flush at least every "
                f"{self.window} steps"
            )
        self._pending.append((info, int(step)))

    def pending_count(self) -> int:
        """Steps appended since the last flush (the current window's size)."""
        return len(self._pending)

    def take_window(self):
        """Hand the pending ``(info, step)`` list to a flush; clears it."""
        pending, self._pending = self._pending, []
        return pending

    def snapshot(self, ring: torch.Tensor) -> Snapshot:
        """A copy of ``ring`` that later steps do not write: a clone on the
        current (compute) stream and, on CUDA, an event recorded after it."""
        copy = ring.clone()
        ready = None
        if copy.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        return Snapshot(copy, ready)

    def fetch(self, snapshot: Snapshot) -> np.ndarray:
        """The default ``device_get``: the snapshot on the host. A CUDA
        snapshot is copied on the side stream after its event, into the
        pinned buffer, and waited for through an event (which blocks this
        thread only); the returned array is that buffer's, valid until the
        next fetch."""
        tensor, ready = snapshot
        if not tensor.is_cuda:
            return tensor.numpy()
        with torch.cuda.device(tensor.device), torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            self._host.copy_(tensor, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return self._host.numpy()

    def resolve(self, snapshot: Snapshot, pending):
        """ONE host transfer of the whole ring; returns ``[(info, {k:
        value})]`` with the keys as floats and each block as a numpy array
        of its shape (a copy)."""
        if not pending:
            return []
        self.transfers += 1
        host = np.asarray(self._device_get(snapshot))
        out = []
        for info, step in pending:
            row = host[step % self.window]
            values = {k: float(row[i]) for i, k in enumerate(self.keys)}
            for name, (lo, hi) in self._spans.items():
                values[name] = np.array(row[lo:hi]).reshape(self.blocks[name])
            out.append((info, values))
        return out
