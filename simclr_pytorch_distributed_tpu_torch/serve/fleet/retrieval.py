"""NeighborIndex: brute-force cosine retrieval over served rows, scored on
the card (the port of the JAX package's ``serve/fleet/retrieval.py``).

``/neighbors`` turns the embedding service into a retrieval service: every
row served through ``/embed`` is inserted (content-keyed, like the
embedding cache) into a bounded per-model index, and a query image's
nearest neighbors are the stored rows with the highest cosine similarity
to its embedding.

The index is bounded (LRU eviction at ``capacity``), so scoring is one
``[q, dim] @ [dim, capacity]`` product: one ``torch.matmul`` over a fixed
``[capacity, dim]`` device tensor, a plain product that the JAX package
too computes outside any kernel of its own. The host keeps the canonical
``[capacity, dim]`` buffer and a validity mask and uploads them lazily,
once per burst of mutations (the ``dirty`` flag), not per query; queries
are padded to the query buckets ``(1, 8, 32)``, the engine's bucket
discipline. Free and evicted slots score ``-inf`` through the mask, so
they never outrank a stored row.

Embedding spaces are per (model, version): the registry gives a promoted
version a new, empty index, since the old version's rows are not
comparable to the new version's queries.

Determinism: rows are L2-normalized on insert and on query (cosine = dot
of unit rows), and eviction order is insert/update recency only (queries
never touch it), both reproducible by a numpy oracle.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from simclr_pytorch_distributed_tpu_torch.train.supcon import resolve_device

QUERY_BUCKETS = (1, 8, 32)


def _normalize(rows: np.ndarray) -> np.ndarray:
    rows = np.asarray(rows, np.float32)
    norms = np.linalg.norm(rows, axis=-1, keepdims=True)
    return rows / np.maximum(norms, 1e-12)


class NeighborIndex:
    """Bounded content-keyed store of unit embedding rows + device scorer.
    ``device`` is ``'cuda'`` (the default), ``'cpu'`` or a
    ``torch.device``."""

    def __init__(self, dim: int, capacity: int = 4096, device="cuda"):
        if dim < 1 or capacity < 1:
            raise ValueError(f"need dim, capacity >= 1, got {dim}/{capacity}")
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.device = resolve_device(torch.device(device).type)
        self._buf = np.zeros((capacity, dim), np.float32)
        self._valid = np.zeros((capacity,), bool)
        self._slot_key: List = [None] * capacity
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # key -> slot, LRU
        self._free = list(range(capacity - 1, -1, -1))  # pop() yields slot 0 first
        self._lock = threading.Lock()
        self._dirty = True
        self._dev = None  # (device db, device mask) snapshot
        self._stats = {"inserts": 0, "updates": 0, "evictions": 0, "queries": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def add(self, keys: Sequence[str], rows: np.ndarray) -> None:
        """Insert/update ``(key, row)`` pairs; refreshes LRU recency for
        keys already present (their row is overwritten: the same content
        under one model version embeds identically, so this is idempotence,
        not drift)."""
        rows = _normalize(rows)
        if len(keys) != rows.shape[0] or rows.shape[1] != self.dim:
            raise ValueError(
                f"{len(keys)} keys vs rows {rows.shape}, index dim {self.dim}"
            )
        with self._lock:
            for key, row in zip(keys, rows):
                slot = self._slots.get(key)
                if slot is not None:
                    self._stats["updates"] += 1
                elif self._free:
                    slot = self._free.pop()
                    self._stats["inserts"] += 1
                else:
                    # full: reuse the least-recently-inserted key's slot
                    _, slot = self._slots.popitem(last=False)
                    self._slot_key[slot] = None
                    self._stats["evictions"] += 1
                    self._stats["inserts"] += 1
                self._buf[slot] = row
                self._valid[slot] = True
                self._slot_key[slot] = key
                self._slots[key] = slot
                self._slots.move_to_end(key)
            self._dirty = True

    def clear(self) -> None:
        with self._lock:
            self._buf[:] = 0.0
            self._valid[:] = False
            self._slot_key = [None] * self.capacity
            self._slots.clear()
            self._free = list(range(self.capacity - 1, -1, -1))
            self._dirty = True
            self._dev = None

    def _device_snapshot(self):
        """Upload the buffer once per mutation burst (under the lock: the
        first query after a write pays the H2D, its peers reuse it)."""
        if self._dirty or self._dev is None:
            self._dev = (torch.from_numpy(self._buf.copy()).to(self.device),
                         torch.from_numpy(self._valid.copy()).to(self.device))
            self._dirty = False
        return self._dev

    @staticmethod
    def _bucket(n: int) -> int:
        for b in QUERY_BUCKETS:
            if n <= b:
                return b
        return QUERY_BUCKETS[-1]

    def query(
        self, rows: np.ndarray, k: int
    ) -> List[List[Tuple[str, float]]]:
        """Top-``k`` ``(key, cosine)`` per query row, best first; equal
        scores in slot order (the insertion order until an eviction), so a
        query's answer repeats whatever the tie.

        The O(capacity * dim) scoring runs on the device against the
        resident snapshot; top-k selection over ``capacity`` scalars runs
        on the host (``argpartition``, whatever ``k``, then every slot tied
        with the k-th score sorted stably)."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        rows = _normalize(np.atleast_2d(rows))
        n = rows.shape[0]
        with self._lock:
            self._stats["queries"] += n
            entries = len(self._slots)
            if entries == 0:
                return [[] for _ in range(n)]
            db, valid = self._device_snapshot()
            slot_key = list(self._slot_key)
        k_eff = min(int(k), entries)
        out: List[List[Tuple[str, float]]] = []
        step = QUERY_BUCKETS[-1]
        for lo in range(0, n, step):
            chunk = rows[lo:lo + step]
            bucket = self._bucket(chunk.shape[0])
            padded = np.zeros((bucket, self.dim), np.float32)
            padded[: chunk.shape[0]] = chunk
            with torch.inference_mode():
                q = torch.from_numpy(padded).to(self.device)
                scores = torch.matmul(q, db.T)  # [bucket, capacity]
                scores = torch.where(valid[None, :], scores, float("-inf"))
                scores = scores.cpu().numpy()
            for row_scores in scores[: chunk.shape[0]]:
                top = np.argpartition(-row_scores, k_eff - 1)[:k_eff]
                # argpartition picks among ties arbitrarily: take every slot
                # at or above the k-th score, in slot order, and sort stably
                top = np.flatnonzero(row_scores >= row_scores[top].min())
                top = top[np.argsort(-row_scores[top], kind="stable")][:k_eff]
                out.append([
                    (slot_key[slot], float(row_scores[slot])) for slot in top
                ])
        return out

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._slots),
                "capacity": self.capacity,
                "dim": self.dim,
                **self._stats,
            }
