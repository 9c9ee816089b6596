"""Host-side batch iteration: the DistributedSampler + DataLoader equivalent.

Batch composition is byte-identical to the JAX package's ``EpochLoader``
(shuffled, ``drop_last``): one numpy permutation per epoch seeded with
``base_seed + epoch``, truncation to whole global batches, and
``start_step`` skipping the already-consumed prefix of that permutation.
Process ``r`` of ``P`` takes rows ``r * b .. (r + 1) * b - 1`` of every
global batch, ``b = batch_size / P`` (JAX ``data/pipeline.py:207-213``), so
the processes together see the global batch the one-process run sees. A
background thread assembles batch k+1 (a numpy row gather) while the
device runs step k.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


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
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.local_batch = batch_size // process_count
        self._lo = process_index * self.local_batch
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        self.batch_size = batch_size
        self.base_seed = base_seed
        self.prefetch = prefetch
        n = len(images)
        self.steps_per_epoch = n // batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(f"dataset of {n} examples smaller than one batch ({batch_size})")

    def _batches(self, epoch: int, start_step: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.random.default_rng(self.base_seed + epoch).permutation(len(self.images))
        for step in range(start_step, self.steps_per_epoch):
            sel = order[step * self.batch_size:(step + 1) * self.batch_size]
            sel = sel[self._lo:self._lo + self.local_batch]
            yield self.images[sel], self.labels[sel].astype(np.int32, copy=False)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass; ``epoch`` seeds the shuffle (``sampler.set_epoch``)."""
        if not 0 <= start_step < self.steps_per_epoch:
            raise ValueError(f"start_step {start_step} outside [0, {self.steps_per_epoch})")
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
