"""serve/: batched embedding inference on the card (the port of the JAX
package's ``serve/``).

Turns any checkpoint the port's trainers write (or a reference ``.pth``)
into an embedding service:

- :mod:`engine`: ``EmbeddingEngine``, checkpoint -> eval-mode encoder on
  the card behind batch buckets, with a split async API (``dispatch() ->
  InflightBatch``, ``result()``, which waits on the batch's own CUDA
  event) and an optional bf16 compute dtype;
- :mod:`batcher`: ``DynamicBatcher``, the request queue coalescing
  concurrent submits into micro-batches under ``max_batch``/
  ``max_wait_ms``, pipelined (up to ``max_inflight`` batches on the card
  while the assembler keeps dispatching), with bounded-queue backpressure
  (``QueueFull``) and per-request timeouts;
- :mod:`cache`: ``EmbeddingCache``, a content-keyed LRU over computed rows
  (keys carry the model's identity and weights, so shared caches survive
  hot-swaps);
- :mod:`server`: the standard library's ``http.server`` JSON endpoint
  (``/embed``, ``/healthz``, ``/stats``, ``/metrics``), ``python -m
  simclr_pytorch_distributed_tpu_torch.serve.server``;
- :mod:`fleet`: several named checkpoint versions behind one server, with
  hot-swap promotion, per-tenant admission, ``/neighbors`` retrieval, and
  the frontend the replica-fleet supervisor (``supervise/``) manages.
"""

from simclr_pytorch_distributed_tpu_torch.serve.batcher import (  # noqa: F401
    DynamicBatcher,
    QueueFull,
    RequestTimeout,
)
from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache  # noqa: F401
from simclr_pytorch_distributed_tpu_torch.serve.engine import (  # noqa: F401
    EmbeddingEngine,
    InflightBatch,
)
