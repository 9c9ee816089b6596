"""Host-side batch iteration: the DistributedSampler + DataLoader equivalent.

Batch composition is byte-identical to the JAX package's ``EpochLoader``
(shuffled, ``drop_last``): one numpy permutation per epoch seeded with
``base_seed + epoch``, truncation to whole global batches, and
``start_step`` skipping the already-consumed prefix of that permutation.
Process ``r`` of ``P`` takes rows ``r * b .. (r + 1) * b - 1`` of every
global batch, ``b = batch_size / P`` (JAX ``data/pipeline.py:207-213``), so
the processes together see the global batch the one-process run sees. A
background thread assembles batch k+1 while the device runs step k, with
the native row gather (``data/native_gather.py``: one memcpy a row, the
GIL released) where it builds, numpy's otherwise.

The device stores (``data/device_store.py``) read the loader's own
permutation (:meth:`EpochLoader._epoch_order`, the one source that
:meth:`EpochLoader._batches` also uses), its ``drop_last`` geometry, its
process slice (``_lo:_hi``) and :meth:`EpochLoader.check_start_step`, so a
batch is the same bytes in every placement.

The bounds come from :func:`share_splits` (JAX ``data/pipeline.py:42-108``,
copied here, since the port imports nothing of the JAX package), which
takes a share hint ``host:factor``: a straggling process hands part of its
share to its peers, and the union of the slices stays the global batch.
The port's supervisor exports that hint as :data:`FLEET_SHARE_ENV` into a
``restart_rebalanced`` relaunch (``supervise/launch.share_env``). As in the
JAX package, the trainers do not read it: the train step needs equal
slices. Its one reader is the single-host fleet launcher
(``scripts/port_fleet_launcher.py``), which records the hint it was
launched under.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from simclr_pytorch_distributed_tpu_torch.data import native_gather


# the environment variable that carries a share hint into a relaunch; the
# consumer side owns the spelling, and the supervisor imports it from here
FLEET_SHARE_ENV = "FLEET_SHARE_HINT"


def parse_share_hint(hint: Optional[str]) -> Optional[Tuple[int, float]]:
    """A ``"host:factor"`` share hint as ``(host, factor)``; ``None`` for
    anything malformed, which degrades to the uniform split rather than
    raising (the hint is advisory input from the environment)."""
    if not hint:
        return None
    try:
        host_s, factor_s = str(hint).split(":", 1)
        host, factor = int(host_s), float(factor_s)
    except ValueError:
        return None
    if host < 0 or not (0.0 < factor <= 1.0) or factor != factor:
        return None
    return host, factor


def share_splits(global_batch_size: int, process_count: int,
                 hint: Optional[str] = None) -> List[Tuple[int, int]]:
    """Per-process ``[lo, hi)`` bounds into each global batch: uniform
    (``global_batch_size // process_count`` each) unless ``hint`` names a
    valid process and factor; that process then keeps
    ``round(per_proc * factor)`` rows (at least 1) and the deficit spreads
    evenly over the others, the remainder to the lowest indices. The bounds
    are contiguous, start at 0 and end at ``global_batch_size``."""
    per_proc = global_batch_size // process_count
    sizes = [per_proc] * process_count
    parsed = parse_share_hint(hint)
    if parsed is not None and process_count > 1:
        host, factor = parsed
        if host < process_count:
            keep = max(1, int(round(per_proc * factor)))
            deficit = per_proc - keep
            if deficit > 0:
                sizes[host] = keep
                bump, rem = divmod(deficit, process_count - 1)
                others = [i for i in range(process_count) if i != host]
                for j, i in enumerate(others):
                    sizes[i] += bump + (1 if j < rem else 0)
    bounds, lo = [], 0
    for size in sizes:
        bounds.append((lo, lo + size))
        lo += size
    return bounds


class EpochLoader:
    """Iterates this process's ``(images_u8, labels)`` slices of the global
    batches of one epoch at a time; ``batch_size`` is the global batch."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        base_seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        share_hint: Optional[str] = None,
    ):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        # this process's [lo, hi) window into every global batch
        self.share_bounds = share_splits(batch_size, process_count, share_hint)
        self._lo, self._hi = self.share_bounds[process_index]
        self.local_batch = self._hi - self._lo
        self.process_index, self.process_count = process_index, process_count
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        self.batch_size = batch_size
        self.base_seed = base_seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        n = len(images)
        # drop_last truncates to whole global batches (the training path);
        # without it the last batch is the ragged tail
        self.steps_per_epoch = n // batch_size if drop_last else -(-n // batch_size)
        if self.steps_per_epoch == 0:
            raise ValueError(f"dataset of {n} examples smaller than one batch ({batch_size})")

    def check_start_step(self, start_step: int) -> None:
        """Raise unless ``start_step`` is a step of this geometry's epoch: a
        resume offset from a checkpoint of another geometry would otherwise
        make a silent zero-step epoch (JAX ``data/pipeline.py:184``). The
        drivers call it before their step loop, with or without a store."""
        if not 0 <= start_step < self.steps_per_epoch:
            raise ValueError(f"start_step {start_step} outside [0, {self.steps_per_epoch})")

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's permutation of the dataset, seeded ``base_seed +
        epoch``: the one source of batch composition, for the host batches
        and the device stores alike."""
        return np.random.default_rng(self.base_seed + epoch).permutation(len(self.images))

    def _batches(self, epoch: int, start_step: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_order(epoch)
        for step in range(start_step, self.steps_per_epoch):
            sel = order[step * self.batch_size:(step + 1) * self.batch_size]
            yield native_gather.gather(self.images, self.labels, sel[self._lo:self._hi])

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass; ``epoch`` seeds the shuffle (``sampler.set_epoch``)."""
        self.check_start_step(start_step)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def worker():
            # an error is shipped through the queue and re-raised on the
            # consumer's thread, so the consumer never waits on a dead worker
            try:
                for item in self._batches(epoch, start_step):
                    if stop.is_set():
                        return
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 — forwarded, not handled
                q.put(e)
                return
            q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True, name="EpochLoader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that abandons the epoch closes the generator: stop
            # the worker and drain until it exits, or it blocks in put()
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)

    def __len__(self) -> int:
        return self.steps_per_epoch
