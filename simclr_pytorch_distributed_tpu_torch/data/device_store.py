"""Data placement: the dataset or a window of batches on the device.

The counterpart of the JAX package's ``data/device_store.py`` (its budget
functions ``:79-175``, the ladder ``:178-378``, ``DeviceStore :408`` and
``WindowStore :506``), on one CUDA device a process:

- :class:`DeviceStore` (``--data_placement device``) uploads the uint8
  dataset and its labels to the run's device once. Each epoch it uploads
  one ``[steps, batch]`` index matrix (through pinned memory, behind the
  injectable ``index_put``) and runs one ``index_select`` gather into a
  ``[steps, B_local, H, W, C]`` buffer and its ``[steps, B_local]`` labels,
  ``B_local`` being this process's column block of every global batch (the
  loader's ``_lo:_hi``). A step's batch is ``buffer[idx]``: a view, with
  no host work, no transfer and no sync.
- :class:`WindowStore` (``window``) keeps a ``[W, B_local, ...]`` window of
  batches on the device while a one-worker thread stages the next window
  on the store's own CUDA stream: one upload a window (behind the
  injectable ``window_put``), none a step. The window's rows are gathered
  on the host by ``data/native_gather.py`` (numpy's where it cannot build). At the swap the compute stream
  waits on the staged window's event; the host does not.
- :func:`resolve_data_placement` (``auto``) walks device -> window -> host
  against a per-device budget, with one startup banner; its verdict is
  collective over the process group, and it never makes a memmap-backed
  dataset resident.

The permutation is the loader's own (``EpochLoader._epoch_order``), so a
batch is the same bytes in every placement (``tests/test_torch_port_device_store.py``,
``tests/test_torch_port_window_store.py``). The JAX package's gather is
``jnp.take`` on a sharded buffer; here it is one ``index_select`` a
process, since each process holds its own device.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from simclr_pytorch_distributed_tpu_torch.data import native_gather
from simclr_pytorch_distributed_tpu_torch.parallel import mesh
from simclr_pytorch_distributed_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

# The budget where the device reports no free memory (the CPU): far above
# CIFAR-scale data, below any real accelerator's memory.
DEFAULT_BUDGET_BYTES = 4 << 30
# The share of the device's free memory the store may claim: the model,
# optimizer state, activations and the allocator's slack own the rest, so
# 'auto' degrades rather than running out of memory.
BUDGET_FRACTION = 0.4
# Batches a window when --data_window_batches is not given.
DEFAULT_WINDOW_BATCHES = 32

Buffers = Tuple[torch.Tensor, torch.Tensor]


def budget_override_bytes(mb) -> Optional[int]:
    """``--device_budget_mb`` as a budget in bytes; 0 or None (the flag's
    default) keeps the computed budget."""
    return int(mb) << 20 if mb else None


def dataset_nbytes(images: np.ndarray, labels: np.ndarray) -> int:
    return int(images.nbytes) + int(np.asarray(labels).nbytes)


def _is_memmap_backed(arr) -> bool:
    """True if ``arr`` is an ``np.memmap`` or a view of one: the loader's
    ``np.ascontiguousarray`` of a contiguous memmap is a plain ``ndarray``
    whose ``base`` chain still ends at the file."""
    while arr is not None:
        if isinstance(arr, np.memmap):
            return True
        arr = getattr(arr, "base", None)
    return False


def device_budget_bytes(device: Optional[torch.device] = None,
                        fraction: float = BUDGET_FRACTION) -> int:
    """The per-device placement budget: ``fraction`` of the CUDA device's
    free memory (``torch.cuda.mem_get_info``), or the fixed
    :data:`DEFAULT_BUDGET_BYTES` for a device that reports none (the CPU).
    The drivers read it before the model exists, as the JAX package does."""
    if device is None or device.type != "cuda":
        return DEFAULT_BUDGET_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    return max(0, int(free * fraction))


def _row_bytes(images: np.ndarray, labels: np.ndarray) -> int:
    n = max(1, len(images))
    return int(images.nbytes // n) + int(np.asarray(labels).nbytes // n)


def resident_bytes_per_device(images: np.ndarray, labels: np.ndarray,
                              global_batch_size: int, data_parallel: int) -> int:
    """What :class:`DeviceStore` claims on each device: the dataset, plus
    twice this device's share of the ``drop_last`` epoch buffer (epoch
    e + 1's gather lands while epoch e's buffer is still held)."""
    used_rows = (len(images) // global_batch_size) * global_batch_size
    buffer_shard = -(-used_rows * _row_bytes(images, labels) // max(1, data_parallel))
    return dataset_nbytes(images, labels) + 2 * buffer_shard


def windowed_bytes_per_device(images: np.ndarray, labels: np.ndarray,
                              global_batch_size: int, data_parallel: int,
                              window_batches: int) -> int:
    """What :class:`WindowStore` claims on each device: twice one window's
    share (the window in use and the one being staged), whatever the
    dataset's size."""
    steps = max(1, len(images) // global_batch_size)
    w = min(max(1, window_batches), steps)  # the store clamps alike
    shard = -(-w * global_batch_size * _row_bytes(images, labels) // max(1, data_parallel))
    return 2 * shard


def _agree_across_processes(local_ok: bool) -> bool:
    """The AND of every process's verdict, as one ``all_reduce(MIN)`` of an
    int on ``mesh.collective_device()``. The budget is local, but the
    placement decides which uploads and gathers a process runs, so every
    process must take the same rung. Each resolution calls this the same
    number of times on every process (once for an explicit placement, once
    per rung walked under 'auto'), so the all-reduces always pair up. One
    process alone makes no collective."""
    if mesh.world_size() == 1:
        tracing.clock_anchor("placement")
        return local_ok
    with tracing.span("placement_decision", track="main:collective", local=bool(local_ok)):
        flag = torch.tensor([int(bool(local_ok))], dtype=torch.int32,
                            device=mesh.collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    # every process just left the same collective: the fleet's startup
    # alignment point
    tracing.clock_anchor("placement")
    return bool(flag.item())


def resolve_data_placement(
    placement: str,
    images: np.ndarray,
    labels: np.ndarray,
    global_batch_size: int,
    data_parallel: int = 1,
    budget_bytes: Optional[int] = None,
    window_batches: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> str:
    """The ``--data_placement`` verdict, logged: 'host', 'device' or
    'window' (JAX ``data/device_store.py:217``).

    - ``host`` is always honoured.
    - ``device`` and ``window`` are honoured or raise ``ValueError`` before
      step 1, on every process when any process cannot meet them.
    - ``auto`` walks the ladder: 'device' when the dataset is an in-RAM
      array within the budget on every process, else 'window' when twice a
      window fits everywhere (a memmap qualifies: each window reads only
      its own rows), else 'host' with a one-line banner naming the reason.

    ``data_parallel`` is the number of processes the global batch is split
    over; the budget is ``budget_bytes`` or :func:`device_budget_bytes` of
    ``device``."""
    if placement == "host":
        return "host"
    if placement not in ("device", "window", "auto"):
        raise ValueError(f"unknown data_placement {placement!r}")

    def reject(reason: str) -> str:
        if placement != "auto":
            raise ValueError(
                f"--data_placement {placement} cannot be satisfied: {reason}"
                f" — use 'auto' (walks the device->window->host ladder with "
                f"a banner) or 'host'"
            )
        logger.warning("data_placement auto -> host: %s", reason)
        return "host"

    budget = device_budget_bytes(device) if budget_bytes is None else budget_bytes
    w = window_batches or DEFAULT_WINDOW_BATCHES

    # rung 1: the dataset itself on the device
    if _is_memmap_backed(images) or _is_memmap_backed(labels):
        resident_reason = (
            "dataset is memmap-backed (data/folder.py on-disk cache); "
            "device residency would page the whole tree into RAM/HBM"
        )
        need = None
    else:
        need = resident_bytes_per_device(images, labels, global_batch_size, data_parallel)
        resident_reason = None if need <= budget else (
            f"dataset needs {need / 1e6:.1f} MB/device (replicated data + "
            f"2x epoch-buffer shard) > budget {budget / 1e6:.1f} MB"
        )
    # rung 2: the double-buffered window (the dataset stays on the host)
    window_need = windowed_bytes_per_device(images, labels, global_batch_size,
                                            data_parallel, w)
    window_reason = None if window_need <= budget else (
        f"double-buffered {w}-batch window needs {window_need / 1e6:.1f} "
        f"MB/device > budget {budget / 1e6:.1f} MB"
    )

    def log_device() -> str:
        logger.info(
            "data_placement: device (%.1f MB/device resident: %.1f MB "
            "dataset + double-buffered epoch shard; budget %.1f MB)",
            need / 1e6, dataset_nbytes(images, labels) / 1e6, budget / 1e6,
        )
        return "device"

    def log_window(why_not_resident: str) -> str:
        logger.info(
            "data_placement: window (%d batches/window, %.1f MB/device "
            "double-buffered; budget %.1f MB; not fully resident: %s)",
            w, window_need / 1e6, budget / 1e6, why_not_resident,
        )
        return "window"

    peer = (
        "a peer process rejected {0} placement (per-host free-memory "
        "budgets differ); placement selects collective programs, so it "
        "must agree across hosts"
    )
    if placement == "device":
        # every process reaches this point once, whatever its own verdict
        ok_everywhere = _agree_across_processes(resident_reason is None)
        if resident_reason is not None:
            return reject(resident_reason)
        if not ok_everywhere:
            return reject(peer.format("device"))
        return log_device()
    if placement == "window":
        ok_everywhere = _agree_across_processes(window_reason is None)
        if window_reason is not None:
            return reject(window_reason)
        if not ok_everywhere:
            return reject(peer.format("window"))
        return log_window(resident_reason or "explicit window request")
    # auto: one collective a rung; rung 1's outcome is the same everywhere,
    # so every process agrees on whether rung 2's collective runs
    if _agree_across_processes(resident_reason is None):
        return log_device()
    if _agree_across_processes(window_reason is None):
        return log_window(resident_reason or peer.format("device"))
    return reject(window_reason or peer.format("window"))


def make_store(placement: str, loader, device: torch.device,
               budget_bytes: Optional[int] = None, window_batches: Optional[int] = None):
    """The drivers' one call: resolve ``--data_placement`` against the
    loader's own arrays and geometry (what a store would upload), then
    build :class:`DeviceStore` ('device'), :class:`WindowStore` ('window'),
    or return ``None`` (the host loader)."""
    placement = resolve_data_placement(
        placement, loader.images, loader.labels, loader.batch_size,
        data_parallel=loader.process_count, budget_bytes=budget_bytes,
        window_batches=window_batches, device=device,
    )
    if placement == "device":
        return DeviceStore(loader, device)
    if placement == "window":
        return WindowStore(loader, device, window_batches or DEFAULT_WINDOW_BATCHES)
    return None


def _validate_loader_geometry(loader, kind: str) -> None:
    """What both stores need of the loader: ``drop_last`` (every step has
    one shape) and a global batch that splits evenly over the processes."""
    if not loader.drop_last:
        raise ValueError(f"{kind} requires drop_last loaders (the training path);"
                         " ragged tails have no static step shape")
    if loader.batch_size % loader.process_count:
        raise ValueError(f"global batch {loader.batch_size} not divisible by "
                         f"{loader.process_count} processes")


def epoch_index_matrix(loader, epoch: int) -> np.ndarray:
    """The epoch's global batches as a ``[steps, batch]`` int32 matrix: the
    loader's permutation, ``drop_last``-truncated and reshaped. Columns
    ``_lo:_hi`` of row ``s`` are this process's slice of step ``s``."""
    order = loader._epoch_order(epoch)
    steps, batch = loader.steps_per_epoch, loader.batch_size
    return np.ascontiguousarray(order[: steps * batch].reshape(steps, batch).astype(np.int32))


def slice_epoch_step(epoch_images: torch.Tensor, epoch_labels: torch.Tensor,
                     position: int) -> Buffers:
    """One step's batch out of ``[steps or W, B_local, ...]`` buffers: a
    plain index with a host int, a view (JAX's ``lax.dynamic_index_in_dim``
    inside the step)."""
    return epoch_images[position], epoch_labels[position]


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on CUDA through pinned memory, queued on
    the current stream, so the host does not wait for the copy. The pinned
    block stays reserved until the copy completes (PyTorch records the
    copy's event on it)."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class DeviceStore:
    """The dataset on the device and one shuffled epoch buffer, for one
    loader. The permutation and geometry are the loader's, so the store
    and the host loader cannot drift.

    ``index_put`` is the per-epoch upload of the index matrix, injectable
    so that tests count transfers."""

    def __init__(self, loader, device: torch.device, *,
                 index_put: Optional[Callable[[np.ndarray], torch.Tensor]] = None):
        _validate_loader_geometry(loader, "DeviceStore")
        self.loader = loader
        self.device = device
        self._index_put = index_put or self._default_index_put
        self.images, self.labels = self._upload_dataset(
            loader.images, np.ascontiguousarray(np.asarray(loader.labels, np.int32)))
        self._cached_epoch: Optional[int] = None
        self._buffers: Optional[Buffers] = None
        self._index_host: Optional[torch.Tensor] = None

    def _upload_dataset(self, images: np.ndarray, labels: np.ndarray) -> Buffers:
        """The one upload of the dataset and its int32 labels."""
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(labels).to(self.device))

    def _default_index_put(self, idx: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(idx)
        if self.device.type != "cuda":
            return host.to(self.device)
        # the pinned copy is held until the next epoch's upload replaces it
        self._index_host = host.pin_memory()
        return self._index_host.to(self.device, non_blocking=True)

    def epoch_buffers(self, epoch: int) -> Buffers:
        """The epoch's shuffled ``(images [S, B_local, H, W, C], labels [S,
        B_local])`` on the device: one index upload and one gather an
        epoch, cached. The previous epoch's buffers are dropped as the new
        ones land (the 2x bound of :func:`resident_bytes_per_device`)."""
        if self._cached_epoch != epoch:
            # host-side time of the upload and the gather's launch; no sync
            with tracing.span("epoch_gather", track="main:data", epoch=epoch):
                idx = self._index_put(epoch_index_matrix(self.loader, epoch))
                cols = idx[:, self.loader._lo:self.loader._hi]
                steps, local = cols.shape
                flat = cols.reshape(-1)
                images = self.images.index_select(0, flat)
                self._buffers = (images.view(steps, local, *self.images.shape[1:]),
                                 self.labels.index_select(0, flat).view(steps, local))
            self._cached_epoch = epoch
        return self._buffers

    def batch_buffers(self, epoch: int, idx: int) -> Buffers:
        """The buffers step ``idx`` of ``epoch`` slices its batch from (the
        API shared with :class:`WindowStore`): here the whole epoch's."""
        del idx  # every step of the epoch reads the same buffers
        return self.epoch_buffers(epoch)

    def batch(self, epoch: int, idx: int) -> Buffers:
        """Step ``idx``'s ``(images [B_local, H, W, C] uint8, labels
        [B_local] int32)``: views of the epoch buffer."""
        return slice_epoch_step(*self.epoch_buffers(epoch), idx)

    def close(self) -> None:
        """The API shared with :class:`WindowStore`; this store holds no
        thread."""


class _Staged:
    """One staged window: its device tensors, the event that marks its
    upload done on the staging stream (None off CUDA)."""

    __slots__ = ("buffers", "event")

    def __init__(self, buffers: Buffers, event: Optional[torch.cuda.Event]):
        self.buffers, self.event = buffers, event


class WindowStore:
    """A double-buffered window of ``W`` batches on the device.

    Window ``w`` of epoch ``e`` is rows ``[w*W, (w+1)*W)`` of
    :func:`epoch_index_matrix`, this process's columns ``_lo:_hi`` of them
    gathered on the host and uploaded as one ``[W, B_local, ...]`` block.
    The epoch's short last window is padded back to ``W`` rows with rows no
    step slices (a step's position ``idx % W`` stays below the tail's
    length). Mid-epoch resume asks for ``batch_buffers(epoch,
    start_step)``, which lands in window ``start_step // W``.

    While window ``w`` trains, a one-worker thread stages window ``w + 1``
    on the store's own CUDA stream and records an event there. The swap at
    the boundary makes the compute stream wait on that event and tells the
    allocator the compute stream uses the window (``record_stream``), so
    its memory is not handed out again while a step reads it; the host
    does not wait. Prefetch stays within the epoch: an epoch's first window
    is staged on the calling thread, so an epoch makes exactly ``n_windows``
    uploads.

    ``window_put`` is the per-window upload of the process-local ``(images,
    labels)`` blocks, injectable so that tests count transfers;
    ``prefetch=False`` stages every window on the calling thread."""

    def __init__(self, loader, device: torch.device,
                 window_batches: int = DEFAULT_WINDOW_BATCHES, *,
                 window_put: Optional[Callable[[np.ndarray, np.ndarray], Buffers]] = None,
                 prefetch: bool = True):
        _validate_loader_geometry(loader, "WindowStore")
        if window_batches < 1:
            raise ValueError(f"window_batches must be >= 1, got {window_batches}")
        self.loader = loader
        self.device = device
        self.window_batches = min(window_batches, loader.steps_per_epoch)
        self.n_windows = -(-loader.steps_per_epoch // self.window_batches)
        self._window_put = window_put or self._default_put
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._executor = (ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="WindowStore-prefetch")
                          if prefetch else None)
        self._epoch_idx: Optional[Tuple[int, np.ndarray]] = None
        self._current = None  # (epoch, window, buffers)
        self._next = None  # (epoch, window, Future of _Staged)

    def _default_put(self, images: np.ndarray, labels: np.ndarray) -> Buffers:
        """The window's upload, on the current stream (the store's staging
        stream when :meth:`_stage` calls it)."""
        return to_device(images, self.device), to_device(labels, self.device)

    def _index_rows(self, epoch: int, window: int) -> np.ndarray:
        cached = self._epoch_idx
        if cached is None or cached[0] != epoch:
            # a stale prefetch may race this: at worst one recompute, and
            # the tuple swap is atomic
            cached = (epoch, epoch_index_matrix(self.loader, epoch))
            self._epoch_idx = cached
        w = self.window_batches
        rows = cached[1][window * w:(window + 1) * w]
        if rows.shape[0] < w:
            # the short tail: pad back to [W, B] with rows no step slices
            rows = np.concatenate([rows, np.repeat(rows[:1], w - rows.shape[0], axis=0)])
        return rows

    def _stage(self, epoch: int, window: int) -> _Staged:
        """Gather this process's columns of one window on the host and
        upload them; on CUDA on the store's stream, ending in an event."""
        with tracing.span("window_stage", track="store:stage", epoch=epoch, window=window):
            rows = self._index_rows(epoch, window)[:, self.loader._lo:self.loader._hi]
            images, labels = native_gather.gather(self.loader.images, self.loader.labels, rows)
            images, labels = np.ascontiguousarray(images), np.ascontiguousarray(labels)
            if self._stream is None:
                return _Staged(self._window_put(images, labels), None)
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                buffers = self._window_put(images, labels)
                event = torch.cuda.Event()
                event.record(self._stream)
            return _Staged(buffers, event)

    def _adopt(self, staged: _Staged) -> Buffers:
        """Hand a staged window to the compute stream: it waits on the
        upload's event (the host does not), and the allocator learns that
        the compute stream reads the window's memory."""
        if staged.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.event)
            for t in staged.buffers:
                t.record_stream(compute)
        return staged.buffers

    def batch_buffers(self, epoch: int, idx: int) -> Buffers:
        """The window containing step ``idx`` of ``epoch``. Within a window
        the cached pair; at a boundary the staged window is swapped in and
        the next one handed to the prefetch thread. A staging error raises
        here, on the training thread."""
        window = idx // self.window_batches
        cur = self._current
        if cur is not None and cur[0] == epoch and cur[1] == window:
            return cur[2]
        nxt, self._next = self._next, None
        hit = nxt is not None and nxt[0] == epoch and nxt[1] == window
        # the training thread's blocking part of the boundary: near zero
        # when the prefetch won, a whole stage when it did not
        with tracing.span("window_swap", track="main:data", epoch=epoch, window=window,
                          prefetched=hit):
            if hit:
                staged = nxt[2].result()
            else:
                if nxt is not None and not nxt[2].cancel():
                    # a jump (resume, rollback) abandoned a window whose
                    # stage is running: wait it out and drop it before
                    # staging the next, or the device briefly holds a third
                    # window where the ladder admitted two
                    try:
                        # the future outlives this call: drop its window
                        nxt[2].result().buffers = None
                    except Exception:  # noqa: BLE001 — the stale stage failed: nothing to free
                        pass
                nxt = None
                staged = self._stage(epoch, window)
            buffers = self._adopt(staged)
        self._current = (epoch, window, buffers)
        if self._executor is not None and window + 1 < self.n_windows:
            self._next = (epoch, window + 1,
                          self._executor.submit(self._stage, epoch, window + 1))
        return buffers

    def batch(self, epoch: int, idx: int) -> Buffers:
        """Step ``idx``'s ``(images [B_local, H, W, C] uint8, labels
        [B_local] int32)``: views of its window."""
        return slice_epoch_step(*self.batch_buffers(epoch, idx), idx % self.window_batches)

    def close(self) -> None:
        """Stop the prefetch worker and drop the staged window. The worker
        is not a daemon, so without this an early exit (exit 75) would wait
        at interpreter exit for an upload nobody reads. A queued stage is
        cancelled; at most one running stage finishes in the background.
        After close the store stages on the calling thread."""
        nxt, self._next = self._next, None
        if nxt is not None:
            nxt[2].cancel()
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
