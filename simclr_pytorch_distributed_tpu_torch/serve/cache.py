"""Content-keyed LRU result cache for computed embedding rows (the port's
copy of the JAX package's ``serve/cache.py``; numpy and the standard
library only).

Serving traffic is heavy-tailed: the same images (popular items, retry
storms, deduplicated uploads) recur far more often than a uniform draw would
suggest, and a ResNet forward is ~10^8 FLOPs per image while a hash of the
raw uint8 bytes is ~10^3 — so a small LRU in front of the engine converts
repeat traffic into O(hash) lookups. Keys are content hashes of the raw
image bytes (plus the engine's preprocessing fingerprint, see
``EmbeddingEngine._cache_key``), so two byte-identical images always share an
entry regardless of which request they arrived in.

The key must carry MODEL IDENTITY, not just content: the engine's
fingerprint prefix includes the served ``identity`` (``"<name>@v<version>"``,
stamped by the fleet registry at promote time) on top of the weights probe,
so a hot-swap promotion can never serve a stale hit computed by the retired
version — even when the new checkpoint's weights are byte-identical
(``EmbeddingEngine.set_identity``).

Thread-safe: the batcher worker writes while HTTP stats readers poll
counters. Stored rows are frozen (``writeable=False``) so a caller mutating a
returned row cannot poison later hits.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np


class EmbeddingCache:
    """Bounded LRU of ``key -> embedding row`` with hit/miss/eviction counters."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: bytes) -> Optional[np.ndarray]:
        with self._lock:
            row = self._data.get(key)
            if row is None:
                self._misses += 1
                return None
            self._data.move_to_end(key)
            self._hits += 1
            return row

    def put(self, key: bytes, row: np.ndarray) -> None:
        self.put_many([(key, row)])

    def put_many(self, items) -> None:
        """Insert ``[(key, row), ...]`` under ONE lock acquisition.

        The pipelined completion stage lands a whole engine batch at once
        (serve/engine.py ``InflightBatch.result``); taking the lock per row
        would interleave lock traffic with the HTTP stats readers for every
        row of every batch. :meth:`put` is the single-row spelling.
        """
        frozen_items = []
        for key, row in items:
            frozen = np.array(row, copy=True)
            frozen.setflags(write=False)
            frozen_items.append((key, frozen))
        if not frozen_items:
            return
        with self._lock:
            for key, frozen in frozen_items:
                self._data[key] = frozen
                self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "hit_rate": (self._hits / total) if total else 0.0,
            }
