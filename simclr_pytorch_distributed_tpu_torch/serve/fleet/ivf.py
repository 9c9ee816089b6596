"""IVFIndex — two-tier inverted-file cosine retrieval (the sublinear rung).

The port's copy of the JAX package's ``serve/fleet/ivf.py`` (numpy and the
standard library only), so the port and the JAX package answer the same
queries with the same ids and lists on the same rows and seed.

Brute force (`retrieval.NeighborIndex`) scores every stored row per query:
O(capacity * dim) compute and a full-buffer H2D re-upload per mutation
burst. Right at the 4096-row default, hostile at the 10^5-10^6-row corpus
the north star implies. The IVF rung (Jegou et al.'s coarse-quantizer
design; Johnson et al.'s billion-scale Faiss) makes query cost
O(nlist * dim + nprobe * avg_list_len * dim):

- **coarse quantizer** — ``nlist`` k-means centroids trained from the
  index's OWN stored rows (spherical mini-batch Lloyd's, seeded: same
  seed + same insert order -> identical centroids, lists, and answers).
  Training triggers itself: first when the corpus reaches
  ``train_min_rows``, then again whenever rows inserted since the last
  train exceed ``retrain_drift`` of the corpus that trained it — served
  embeddings drift with traffic, and a quantizer trained on last week's
  corpus probes the wrong lists;
- **inverted lists** — every unit row lives in exactly one per-centroid
  list; a query scores the ``[nlist, dim]`` centroid matrix, picks the
  ``nprobe`` nearest lists, and runs EXACT cosine over only those rows.
  Recall@k against the brute oracle is the measured price.

Before the first train every row sits in one provisional list and a query
scans it exactly — the untrained index IS brute force, so small corpora
never pay approximation error (and `--retrieval_impl auto` only picks IVF
above a capacity threshold anyway: ``resolve_retrieval_impl``).

Contracts carried over from the brute rung, unchanged on the wire:
content-keyed idempotent ``add`` (re-adding a key overwrites its row and
refreshes recency), ``clear()`` on promote (new version = new embedding
space — centroids are dropped too, they were trained on the old space's
rows), and queries NEVER touch recency. Eviction becomes **per-list with
a global budget**: the ``capacity`` bound is global, but when it is hit
the arriving row's TARGET list evicts its own least-recently-inserted
entry (falling back to the globally oldest row only when the target list
is empty) — a hot list cannot silently consume the cold lists' corpus,
and eviction stays O(1) instead of rescanning ``nlist`` structures.

Everything here is numpy on host, deliberately: per-query candidate sets
have data-dependent lengths, which is exactly the shape-hostile regime
the engine's bucket discipline exists to avoid, and the win at large
corpus is algorithmic (scan 1/30th of the rows), not kernel-level. The
brute rung keeps its fixed-shape device scorer.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simclr_pytorch_distributed_tpu_torch.serve.fleet.retrieval import _normalize

DEFAULT_NPROBE = 8
# `auto` picks IVF only when the configured corpus bound crosses this:
# below it the brute matmul is already one small device product and IVF
# would only add approximation error
AUTO_IVF_MIN_CAPACITY = 32768


def auto_nlist(capacity: int) -> int:
    """The sqrt(N) rule of thumb, clamped: balances centroid-scan cost
    (nlist * dim) against per-list scan cost (N/nlist * dim per probe)."""
    return max(8, min(1024, int(round(math.sqrt(max(1, capacity))))))


def resolve_retrieval_impl(
    impl: str, capacity: int, nlist: int = 0
) -> Tuple[str, str]:
    """``(resolved_impl, reason)`` for the ``--retrieval_impl`` ladder —
    the ``resolve_loss_impl``/``resolve_conv_impl`` convention: ``auto``
    picks by corpus bound, an explicit choice is honored or raises (a
    silently ignored flag would misreport every latency number built on
    it), and the reason feeds ``config.impl_resolution_banner``."""
    if impl not in ("brute", "ivf", "auto"):
        raise ValueError(
            f"--retrieval_impl must be brute/ivf/auto, got {impl!r}"
        )
    if capacity <= 0:
        # no index at all: nothing to resolve, but an explicit ivf ask is
        # a config contradiction, not a preference to drop silently
        if impl == "ivf":
            raise ValueError(
                "--retrieval_impl ivf needs a retrieval index: "
                "--index_capacity is 0 (/neighbors disabled)"
            )
        return "brute", "retrieval index disabled (--index_capacity 0)"
    nlist_eff = nlist or auto_nlist(capacity)
    if impl == "ivf":
        if capacity < nlist_eff:
            raise ValueError(
                f"--retrieval_impl ivf needs index_capacity >= nlist "
                f"({capacity} < {nlist_eff}): every centroid needs a row "
                "to own — raise --index_capacity or lower --ivf_nlist"
            )
        return "ivf", (
            f"explicit request ({nlist_eff} lists over "
            f"{capacity}-row budget)"
        )
    if impl == "brute":
        return "brute", "explicit request (exact cosine over every row)"
    if capacity >= AUTO_IVF_MIN_CAPACITY:
        return "ivf", (
            f"index_capacity {capacity} >= {AUTO_IVF_MIN_CAPACITY}: "
            f"brute is O(capacity*dim) per query at this corpus bound "
            f"({nlist_eff} lists)"
        )
    return "brute", (
        f"index_capacity {capacity} < {AUTO_IVF_MIN_CAPACITY}: "
        "exact brute scan is cheap and recall-free at this bound"
    )


class IVFIndex:
    """Bounded content-keyed store of unit rows behind a k-means coarse
    quantizer. Same surface as :class:`~retrieval.NeighborIndex` —
    ``add``/``query``/``clear``/``stats``/``len`` — so the registry and
    frontend are impl-blind."""

    def __init__(
        self,
        dim: int,
        capacity: int = 4096,
        *,
        nlist: int = 0,
        nprobe: int = DEFAULT_NPROBE,
        seed: int = 0,
        train_min_rows: Optional[int] = None,
        retrain_drift: float = 0.5,
        kmeans_iters: int = 10,
        kmeans_batch: int = 4096,
    ):
        if dim < 1 or capacity < 1:
            raise ValueError(f"need dim, capacity >= 1, got {dim}/{capacity}")
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.nlist = int(nlist) or auto_nlist(capacity)
        if self.nlist < 1 or self.nlist > capacity:
            raise ValueError(
                f"need 1 <= nlist <= capacity, got {self.nlist}/{capacity}"
            )
        self.nprobe = max(1, min(int(nprobe), self.nlist))
        self.seed = int(seed)
        # enough rows that every centroid can own a few before we commit
        # to a partition; below it the single provisional list is exact
        self.train_min_rows = int(
            train_min_rows if train_min_rows is not None
            else min(capacity, max(256, 4 * self.nlist))
        )
        self.retrain_drift = float(retrain_drift)
        self.kmeans_iters = int(kmeans_iters)
        self.kmeans_batch = int(kmeans_batch)

        self._lock = threading.Lock()
        self._buf = np.zeros((capacity, dim), np.float32)  # slot -> unit row
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._order: "OrderedDict[str, int]" = OrderedDict()  # global recency
        self._key_list: Dict[str, int] = {}  # key -> owning list id
        # list id -> (key -> slot), insertion-recency ordered; one
        # provisional list 0 until the first train
        self._lists: List["OrderedDict[str, int]"] = [OrderedDict()]
        self._centroids: Optional[np.ndarray] = None  # [n_lists, dim]
        # per-list cached [m, dim] matrix + key tuple; invalidated per
        # mutated list (the brute index's one-upload-per-burst discipline,
        # per list)
        self._cache: Dict[int, Tuple[np.ndarray, Tuple[str, ...]]] = {}
        self._rows_at_train = 0
        self._inserts_since_train = 0
        self._stats = {
            "inserts": 0, "updates": 0, "evictions": 0, "queries": 0,
            "probes": 0, "retrains": 0,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    # ------------------------------------------------------------ mutation

    def add(self, keys: Sequence[str], rows: np.ndarray) -> None:
        """Insert/update ``(key, row)`` pairs; idempotent on key (same
        content under one model version embeds identically) and
        recency-refreshing, exactly like the brute rung."""
        rows = _normalize(rows)
        if len(keys) != rows.shape[0] or rows.shape[1] != self.dim:
            raise ValueError(
                f"{len(keys)} keys vs rows {rows.shape}, index dim {self.dim}"
            )
        with self._lock:
            for key, row in zip(keys, rows):
                self._add_one_locked(key, row)
            if self._should_train_locked():
                self._train_locked()

    def _assign_locked(self, row: np.ndarray) -> int:
        if self._centroids is None:
            return 0
        return int(np.argmax(self._centroids @ row))

    def _add_one_locked(self, key: str, row: np.ndarray) -> None:
        old_list = self._key_list.get(key)
        if old_list is not None:
            # update: the row may move lists (the content hash is the
            # identity; the ROW decides the list)
            slot = self._lists[old_list][key]
            new_list = self._assign_locked(row)
            self._buf[slot] = row
            if new_list != old_list:
                del self._lists[old_list][key]
                self._cache.pop(old_list, None)
                self._lists[new_list][key] = slot
                self._key_list[key] = new_list
            else:
                self._lists[old_list].move_to_end(key)
            self._cache.pop(new_list, None)
            self._order[key] = slot
            self._order.move_to_end(key)
            self._stats["updates"] += 1
            return
        list_id = self._assign_locked(row)
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._evict_locked(list_id)
        self._buf[slot] = row
        self._lists[list_id][key] = slot
        self._key_list[key] = list_id
        self._order[key] = slot
        self._cache.pop(list_id, None)
        self._stats["inserts"] += 1
        self._inserts_since_train += 1

    def _evict_locked(self, target_list: int) -> int:
        """Per-list LRU under the global budget: the arriving row's own
        list gives up its least-recently-inserted entry; an empty target
        list falls back to the globally oldest row (some list must pay —
        the budget is global)."""
        if self._lists[target_list]:
            old_key, slot = self._lists[target_list].popitem(last=False)
            del self._order[old_key]
            victim_list = target_list
        else:
            old_key, slot = self._order.popitem(last=False)
            victim_list = self._key_list[old_key]
            del self._lists[victim_list][old_key]
        del self._key_list[old_key]
        self._cache.pop(victim_list, None)
        self._stats["evictions"] += 1
        return slot

    def clear(self) -> None:
        """Promote seam: a new model version is a new embedding space, so
        the rows AND the centroids trained on them are both invalid."""
        with self._lock:
            self._buf[:] = 0.0
            self._free = list(range(self.capacity - 1, -1, -1))
            self._order.clear()
            self._key_list.clear()
            self._lists = [OrderedDict()]
            self._centroids = None
            self._cache.clear()
            self._rows_at_train = 0
            self._inserts_since_train = 0

    # ------------------------------------------------------------ training

    def _should_train_locked(self) -> bool:
        n = len(self._order)
        if self._centroids is None:
            return n >= self.train_min_rows
        return self._inserts_since_train >= max(
            1, int(self.retrain_drift * self._rows_at_train)
        )

    def _train_locked(self) -> None:
        """Seeded spherical mini-batch Lloyd's over the stored rows, then
        a full reassignment. Deterministic: the rng is seeded from
        ``(seed, retrain ordinal)`` and rows are visited in global
        insertion-recency order, so same seed + same insert order means
        identical centroids and identical lists."""
        keys = list(self._order)
        slots = np.fromiter(
            (self._order[k] for k in keys), np.int64, len(keys)
        )
        rows = self._buf[slots]  # [n, dim], recency-ordered
        n = rows.shape[0]
        k = min(self.nlist, n)
        rng = np.random.default_rng((self.seed, self._stats["retrains"]))
        centroids = rows[rng.choice(n, size=k, replace=False)].copy()
        counts = np.ones(k, np.float64)  # Sculley-style per-center rates
        for _ in range(self.kmeans_iters):
            batch = rows[rng.choice(n, size=min(self.kmeans_batch, n),
                                    replace=False)]
            assign = np.argmax(batch @ centroids.T, axis=1)
            for c in np.unique(assign):
                members = batch[assign == c]
                lr = members.shape[0] / (counts[c] + members.shape[0])
                centroids[c] = (1.0 - lr) * centroids[c] + lr * members.mean(0)
                counts[c] += members.shape[0]
            # spherical k-means: cosine assignment needs unit centroids
            centroids /= np.maximum(
                np.linalg.norm(centroids, axis=1, keepdims=True), 1e-12
            )
        self._centroids = centroids.astype(np.float32)
        # full reassignment, chunked to bound the [chunk, k] similarity
        assign = np.empty(n, np.int64)
        for lo in range(0, n, 65536):
            assign[lo:lo + 65536] = np.argmax(
                rows[lo:lo + 65536] @ centroids.T, axis=1
            )
        self._lists = [OrderedDict() for _ in range(k)]
        self._key_list.clear()
        self._cache.clear()
        # recency-ordered visit: each rebuilt list inherits the relative
        # insertion order its entries had before the retrain
        for key, slot, list_id in zip(keys, slots, assign):
            self._lists[int(list_id)][key] = int(slot)
            self._key_list[key] = int(list_id)
        self._rows_at_train = n
        self._inserts_since_train = 0
        self._stats["retrains"] += 1

    # --------------------------------------------------------------- query

    def _list_matrix_locked(self, list_id: int):
        cached = self._cache.get(list_id)
        if cached is None:
            entries = self._lists[list_id]
            keys = tuple(entries)
            slots = np.fromiter(entries.values(), np.int64, len(entries))
            cached = (self._buf[slots], keys)
            self._cache[list_id] = cached
        return cached

    def query(
        self, rows: np.ndarray, k: int
    ) -> List[List[Tuple[str, float]]]:
        """Top-``k`` ``(key, cosine)`` per query row, best first — exact
        cosine over the union of the ``nprobe`` nearest lists' rows."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        rows = _normalize(np.atleast_2d(rows))
        out: List[List[Tuple[str, float]]] = []
        with self._lock:
            self._stats["queries"] += rows.shape[0]
            if not self._order:
                return [[] for _ in range(rows.shape[0])]
            if self._centroids is None:
                probe_plan = [[0]] * rows.shape[0]
            else:
                sims = rows @ self._centroids.T  # [n, n_lists]
                nprobe = min(self.nprobe, sims.shape[1])
                top = np.argpartition(-sims, nprobe - 1, axis=1)[:, :nprobe]
                probe_plan = [
                    lists[np.argsort(-sims[i, lists], kind="stable")]
                    for i, lists in enumerate(top)
                ]
            for row, lists in zip(rows, probe_plan):
                mats, key_sets = [], []
                for list_id in lists:
                    if not self._lists[int(list_id)]:
                        continue
                    mat, keys = self._list_matrix_locked(int(list_id))
                    mats.append(mat)
                    key_sets.append(keys)
                self._stats["probes"] += len(lists)
                if not mats:
                    out.append([])
                    continue
                scores = np.concatenate([m @ row for m in mats])
                keys = [key for keys in key_sets for key in keys]
                k_eff = min(int(k), scores.shape[0])
                top = np.argpartition(-scores, k_eff - 1)[:k_eff]
                top = top[np.argsort(-scores[top], kind="stable")]
                out.append([(keys[i], float(scores[i])) for i in top])
        return out

    # --------------------------------------------------------------- views

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._order),
                "capacity": self.capacity,
                "dim": self.dim,
                "nlist": self.nlist,
                "nprobe": self.nprobe,
                "trained_lists": (
                    0 if self._centroids is None else len(self._lists)
                ),
                **self._stats,
            }
