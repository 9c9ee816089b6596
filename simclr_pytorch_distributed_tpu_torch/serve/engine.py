"""EmbeddingEngine: a checkpoint -> an eval-mode encoder on the card behind
batch buckets.

The port of the JAX package's ``serve/engine.py``. Requests are uint8 NHWC
images of a pinned geometry; the answer is the fp32 ``[n, feat_dim]``
embedding of each image: the encoder's pooled features
(``output='features'``, ``SupConResNet.encode``) or the projection head's
output (``output='projection'``), L2-normalized rows with
``normalize=True`` (the contract the contrastive loss consumes; the
reference normalizes at ``main_supcon.py:283``).

The model runs in ``eval()`` mode under ``torch.inference_mode()``,
channels-last: cuDNN convs and ``nn.BatchNorm2d`` with running statistics,
the probe's frozen encoder (``train/linear.py``). No fused kernel runs: the
fused conv+BN kernels are train-mode only, as the JAX package's Pallas
kernels are (``models/resnet.py:95-96, 179-180, 311-313`` there).

**Buckets.** A request of n images is padded up to the smallest bucket >=
n (default 1/8/32/128), the pad rows are sliced off the result, and
requests above the top bucket are chunked through it. In eval mode every
row's path is independent of the other rows (BN reads running statistics;
convs, pools and matmuls are per row), so within one bucket a padded
batch's rows equal the exact batch's bitwise. Across buckets cuDNN may pick
another algorithm for another batch size, so two buckets agree to float
tolerance only. A fixed bucket set bounds the plans cuDNN settles at a
bucket's first forward: ``stats()['traces'][bucket]`` counts that first
forward and stays 1, the counterpart of the JAX engine's compile count.

**Dispatch and completion.** ``dispatch(images) -> InflightBatch`` runs the
host stages (validation, cache probe, padding into a pinned staging
tensor) and enqueues each bucket chunk's device work without waiting for
it: the non-blocking H2D copy, the forward, and a non-blocking D2H copy of
the rows into pinned host memory, after which it records a CUDA event.
``InflightBatch.result()`` waits on that chunk's own event (never a device-
wide synchronize, which would serialize every other batch in flight),
slices the pad rows off and fills the content cache. ``embed`` is
``dispatch(...).result()``. A chunk's staging and output buffers live on
its handle until ``result()`` has read them, so no pinned buffer is reused
while a copy into or out of it may still run; the work of a chunk runs on
the dispatching thread's current stream (the default stream), so no tensor
crosses streams. ``inference_mode`` is thread-local and is entered by the
thread that dispatches. On the CPU (``device='cpu'``) the same stages run
synchronously, with no pinned memory and no events.

The JAX engine's ``mesh`` (a bucket sharded over the data axis of several
chips) becomes one ``device`` here: the port scales out through the
replica fleet (``supervise/replica_fleet.py``), one process a card.

**bf16** (``dtype='bf16'``): the encoder computes in bf16
(``ResNet.set_compute_dtype``) with BN statistics in fp32, and the output is
cast back to fp32, so the wire contract is unchanged.

The optional ``cache`` (``serve/cache.py``) sits in front of the device:
rows whose content hash hits skip the device, and a request made of hits
alone never reaches it.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from simclr_pytorch_distributed_tpu_torch.models import (
    MODEL_DICT,
    SupConResNet,
    infer_architecture,
)
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    DATASET_STATS,
    AugmentConfig,
    eval_batch,
)
from simclr_pytorch_distributed_tpu_torch.train.supcon import resolve_device
from simclr_pytorch_distributed_tpu_torch.utils import tracing

DEFAULT_BUCKETS = (1, 8, 32, 128)
SERVE_DTYPES = ("fp32", "bf16")


class _Chunk:
    """One bucket chunk's enqueued work: the rows land in ``host`` once
    ``event`` has completed (``None`` on the CPU, where they already
    have). ``staging`` is the chunk's pinned input, held until then."""

    __slots__ = ("host", "event", "staging")

    def __init__(self, host: torch.Tensor, event, staging: Optional[torch.Tensor]):
        self.host = host
        self.event = event
        self.staging = staging

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()  # this chunk's copies only
        return self.host.numpy()


class InflightBatch:
    """Handle to dispatched work whose rows have not been read yet.

    Created by :meth:`EmbeddingEngine.dispatch` once every bucket chunk's
    work is enqueued; ``result()`` is the completion stage: it waits on
    each chunk's event, slices the pad rows off, writes the computed rows
    into the content cache and returns the float32 ``[n, dim]`` array.
    Idempotent: repeat calls return the same array without touching the
    device. The handle owns its chunks' buffers until completed, which is
    what the batcher's in-flight row bound counts (``serve/batcher.py``
    ``max_inflight_images``).
    """

    def __init__(self, engine, out, n, chunks, keys):
        self._engine = engine
        self._out = out
        self._n = n
        self._chunks = chunks  # [(miss row indices, _Chunk)]
        self._keys = keys
        self._done = False
        self._lock = threading.Lock()

    @property
    def n_rows(self) -> int:
        """Total request rows (the batcher's in-flight accounting unit)."""
        return self._n

    def done(self) -> bool:
        with self._lock:
            return self._done

    def result(self) -> np.ndarray:
        with self._lock:
            if not self._done:
                cache = self._engine.cache
                for rows, chunk in self._chunks:
                    emb = chunk.wait()[: len(rows)]
                    self._out[rows] = emb
                    if self._keys is not None:
                        cache.put_many(
                            [(self._keys[i], emb[j]) for j, i in enumerate(rows)]
                        )
                self._chunks = ()  # release the chunks' buffers
                self._done = True
            return self._out


class EmbeddingEngine:
    """Batched eval-mode embedding inference over a frozen encoder.

    ``embed(images) -> np.ndarray``: uint8 NHWC images in, float32
    ``[n, dim]`` embeddings out (module docstring). ``model`` is a
    ``SupConResNet``; ``state_dict``, when given, is loaded into it (its
    ``'module.'``-free reference layout). ``device`` is ``'cuda'`` (the
    default), ``'cpu'`` or a ``torch.device``.
    """

    def __init__(
        self,
        model: SupConResNet,
        state_dict: Optional[dict] = None,
        *,
        device="cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        normalize: bool = False,
        output: str = "features",
        mean: Optional[Tuple[float, ...]] = None,
        std: Optional[Tuple[float, ...]] = None,
        img_size: int = 32,
        cache=None,
        dtype: str = "fp32",
        identity: str = "",
    ):
        if output not in ("features", "projection"):
            raise ValueError(f"output must be features|projection, got {output!r}")
        if dtype not in SERVE_DTYPES:
            raise ValueError(f"dtype must be one of {SERVE_DTYPES}, got {dtype!r}")
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        if len(set(buckets)) != len(buckets):
            raise ValueError(f"duplicate buckets: {buckets}")
        self.device = resolve_device(torch.device(device).type)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.dtype = dtype
        self.model_name = model.arch[0]
        self.buckets = buckets
        self.normalize = bool(normalize)
        self.output = output
        # pinned request geometry: a fixed (H, W) beside the fixed buckets
        # bounds the plans the card settles; an open endpoint accepting any
        # size would settle one per size. Mismatches are rejected in
        # validate_images (HTTP 400).
        self.img_size = int(img_size)
        self.cache = cache
        stats = DATASET_STATS["cifar10"]
        self._aug_cfg = AugmentConfig(
            mean=tuple(mean) if mean else stats[0],
            std=tuple(std) if std else stats[1],
            color_ops=False,
        )
        # cache-key fingerprint: byte-identical images served under another
        # contract (normalization, output) or by another model or checkpoint
        # (one EmbeddingCache may back several engines) never share a row.
        # Every tensor is hashed: BN statistics come first and are identical
        # across fresh checkpoints. One-time cost at construction.
        probe = hashlib.sha1()
        for tensor in model.state_dict().values():
            probe.update(tensor.detach().cpu().contiguous().numpy().tobytes())
        self._weights_probe = probe.hexdigest()[:16]
        if dtype == "bf16":
            # BN statistics and parameters stay fp32 (models/norm.py); the
            # output is cast back to fp32 in _forward
            model.encoder.set_compute_dtype(torch.bfloat16)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.model.requires_grad_(False)
        if output == "features":
            self.feat_dim = MODEL_DICT[self.model_name][1]
        else:
            self.feat_dim = model.arch[2]
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "images": 0,
            "padded_rows": 0,
            "bucket_dispatches": {b: 0 for b in buckets},
            "traces": {},  # bucket -> first forwards (stays 1)
            "cache_hit_rows": 0,
        }
        self.identity = ""
        self.set_identity(identity)

    def set_identity(self, identity: str) -> None:
        """Stamp the engine's served identity (``"<model name>@v<version>"``)
        into its cache-key fingerprint.

        The weights probe separates engines whose weights differ, but a
        hot-swap promotion must invalidate cached rows even when the new
        version's weights are byte-identical (a re-exported or rolled-back
        checkpoint): after ``POST /models/promote`` every hit comes from the
        version that is serving. The registry (``serve/fleet/registry.py``)
        stamps ``name@vN`` before the version takes traffic; not safe to
        call with requests in flight (``_cache_key`` reads the prefix
        without a lock)."""
        self.identity = str(identity)
        self._key_prefix = (
            f"{self.identity}|{self.model_name}|{self._weights_probe}|"
            f"{self.output}|{int(self.normalize)}|{self.dtype}|"
            f"{self._aug_cfg.mean}|{self._aug_cfg.std}|".encode()
        )

    # ------------------------------------------------------------ loading

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "EmbeddingEngine":
        """Build from any ``--ckpt`` spelling (``utils/checkpoint.
        load_model_payload``): a ``.pth`` in the reference layout (the
        port's trainers', the reference's, the JAX package's export) or a
        run folder (its latest complete checkpoint). The architecture is
        read off the state dict, so no ``--model`` flag is needed; the
        dataset's mean/std and the trained ``--size`` come from the
        checkpoint's ``opt`` unless the caller passes them."""
        from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import load_model_payload

        state_dict, meta = load_model_payload(path)
        name, head, feat_dim = infer_architecture(state_dict)
        model = SupConResNet(name, head, feat_dim)
        # the port's opt is the flat config; the JAX export nests it
        config = meta.get("config") or meta
        dataset = config.get("dataset")
        if dataset in DATASET_STATS and "mean" not in kwargs and "std" not in kwargs:
            kwargs["mean"], kwargs["std"] = DATASET_STATS[dataset]
        if "img_size" not in kwargs and config.get("size"):
            kwargs["img_size"] = int(config["size"])
        return cls(model, state_dict, **kwargs)

    @classmethod
    def random_init(
        cls, model_name: str = "resnet10", size: int = 32, seed: int = 0, **kwargs
    ) -> "EmbeddingEngine":
        """Randomly initialized engine, from ``seed`` (the global generator
        is left as it was): benchmarking and tests, since the serving
        stack's behavior does not depend on the weights."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = SupConResNet(model_name)
        kwargs.setdefault("img_size", size)
        return cls(model, **kwargs)

    # ------------------------------------------------------------ compute

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (requests above the top bucket are chunked
        through it)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        bucket = int(images_u8.shape[0])
        with self._lock:
            self._stats["traces"].setdefault(bucket, 1)
        x = eval_batch(images_u8, self._aug_cfg)
        if self.output == "features":
            feats = self.model.encode(x)
        else:
            feats = self.model(x)
        feats = feats.float()
        if self.normalize:
            norms = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
            feats = feats / torch.clamp(norms, min=1e-12)
        return feats

    def _dispatch_chunk(self, images_u8: np.ndarray) -> _Chunk:
        """Pad into a staging tensor and enqueue the chunk's work: H2D,
        forward, D2H into pinned memory, an event after them. Nothing here
        waits for the device; ``_Chunk.wait`` is the one blocking step."""
        n = images_u8.shape[0]
        bucket = self.bucket_for(n)
        cuda = self.device.type == "cuda"
        staging = torch.empty((bucket,) + images_u8.shape[1:], dtype=torch.uint8,
                              pin_memory=cuda)
        buf = staging.numpy()
        buf[:n] = images_u8
        buf[n:] = 0
        with self._lock:
            self._stats["bucket_dispatches"][bucket] += 1
            self._stats["padded_rows"] += bucket - n
        with torch.inference_mode():
            feats = self._forward(staging.to(self.device, non_blocking=True))
            if not cuda:
                return _Chunk(feats, None, None)
            host = torch.empty(feats.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(feats, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return _Chunk(host, event, staging)

    def _cache_key(self, image_u8: np.ndarray) -> bytes:
        h = hashlib.sha1(self._key_prefix)
        h.update(str(image_u8.shape).encode())
        h.update(image_u8.tobytes())
        return h.digest()

    def validate_images(self, images: np.ndarray) -> np.ndarray:
        """Raise ``ValueError`` unless ``images`` matches the engine's pinned
        request geometry. Separate so ingress layers (the batcher's
        ``validate=``, hence the HTTP 400 path) reject bad requests at
        submit instead of failing a coalesced batch."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"expected [n, H, W, 3] images, got shape {images.shape}"
            )
        if images.shape[1:3] != (self.img_size, self.img_size):
            raise ValueError(
                f"this engine serves {self.img_size}x{self.img_size} images "
                f"(pinned at construction; arbitrary sizes would settle plans per "
                f"shape), got {images.shape[1]}x{images.shape[2]}"
            )
        if images.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 images (raw pixels; the engine normalizes), "
                f"got {images.dtype}"
            )
        return images

    def dispatch(self, images: np.ndarray) -> InflightBatch:
        """Start one request's device work without waiting for it.

        Runs every host stage (validation, stats, cache probe, padding)
        and enqueues the work of every bucket chunk of the miss set, so a
        request of several chunks overlaps chunk k+1's dispatch with chunk
        k's compute. The returned :class:`InflightBatch` completes with
        ``result()``; meanwhile the card computes while the caller
        assembles the next batch (``serve/batcher.py`` keeps
        ``max_inflight`` of these in flight).
        """
        images = self.validate_images(images)
        n = images.shape[0]
        out = np.empty((n, self.feat_dim), np.float32)
        if n == 0:
            return InflightBatch(self, out, 0, [], None)
        with self._lock:
            self._stats["requests"] += 1
            self._stats["images"] += n

        if self.cache is None:
            miss_rows = list(range(n))
            keys = None
        else:
            keys = [self._cache_key(images[i]) for i in range(n)]
            miss_rows = []
            for i, key in enumerate(keys):
                row = self.cache.get(key)
                if row is None:
                    miss_rows.append(i)
                else:
                    out[i] = row
            hit_rows = n - len(miss_rows)
            if hit_rows:
                with self._lock:
                    self._stats["cache_hit_rows"] += hit_rows
                # the cache leg of the request path: rows that never reach
                # the device (a full-hit request dispatches nothing)
                tracing.event(
                    "cache_hits", track="serve:cache", rows=hit_rows, n=n
                )

        chunks = []
        max_bucket = self.buckets[-1]
        for lo in range(0, len(miss_rows), max_bucket):
            rows = miss_rows[lo:lo + max_bucket]
            chunks.append((rows, self._dispatch_chunk(images[rows])))
        return InflightBatch(self, out, n, chunks, keys)

    def embed(self, images: np.ndarray) -> np.ndarray:
        """uint8 ``[n, H, W, 3]`` -> float32 ``[n, feat_dim]``.

        Row i's embedding depends only on image i, never on the request
        peers or pad rows it was batched with, so micro-batching and the
        content cache are transparent to callers. The synchronous spelling
        of ``dispatch(...).result()``.
        """
        return self.dispatch(images).result()

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            s = {
                **{k: v for k, v in self._stats.items()
                   if not isinstance(v, dict)},
                "bucket_dispatches": dict(self._stats["bucket_dispatches"]),
                "traces": dict(self._stats["traces"]),
            }
        s["model"] = self.model_name
        s["identity"] = self.identity
        s["output"] = self.output
        s["normalize"] = self.normalize
        s["dtype"] = self.dtype
        s["buckets"] = list(self.buckets)
        s["feat_dim"] = self.feat_dim
        if self.cache is not None:
            s["cache"] = self.cache.stats()
        return s
