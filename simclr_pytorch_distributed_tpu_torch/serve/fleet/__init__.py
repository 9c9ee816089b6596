"""serve/fleet/: multi-model hosting, hot-swap promotion, retrieval (the
port of the JAX package's ``serve/fleet/``).

The single-model stack (engine -> batcher -> server) serves one
checkpoint; a fleet serves several versions at once, promotes new
checkpoints under load, and answers similarity queries:

- :mod:`registry`: :class:`ModelRegistry`, N named checkpoint versions
  behind one server; per-model batchers whose queues survive promotes;
  hot-swap ``promote()`` draining in-flight work on the old engine through
  the dispatch/completion split (zero failed requests across a swap);
  per-(model, tenant) :class:`AdmissionController` quotas over the
  batcher's QueueFull backpressure; per-version cache identity
  (``EmbeddingEngine.set_identity``);
- :mod:`retrieval`: :class:`NeighborIndex`, the bounded, content-keyed,
  LRU-evicted store of served embeddings with a brute-force cosine scorer
  on the card, ``/neighbors``' exact rung and the recall oracle of the
  rest;
- :mod:`ivf`: :class:`IVFIndex`, the sublinear rung (a seeded k-means
  coarse quantizer over the stored rows, per-centroid inverted lists,
  exact cosine over the ``nprobe`` nearest lists, numpy on the host), and
  ``resolve_retrieval_impl``, the ``--retrieval_impl {brute,ivf,auto}``
  ladder;
- :mod:`frontend`: the HTTP surface, ``/embed`` with model routing,
  ``/models/promote``, ``/neighbors`` (``k`` bounded by
  ``--neighbors_max_k``), ``/models``, and ``/metrics``, whose unlabeled
  gauges the replica-fleet supervisor (``supervise/replica_fleet.py``)
  scrapes. ``python -m simclr_pytorch_distributed_tpu_torch.serve.fleet``
  serves it.
"""

from simclr_pytorch_distributed_tpu_torch.serve.fleet.ivf import (  # noqa: F401
    IVFIndex,
    resolve_retrieval_impl,
)
from simclr_pytorch_distributed_tpu_torch.serve.fleet.registry import (  # noqa: F401
    AdmissionController,
    ModelRegistry,
    ModelVersion,
)
from simclr_pytorch_distributed_tpu_torch.serve.fleet.retrieval import (  # noqa: F401
    NeighborIndex,
)
