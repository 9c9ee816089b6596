"""The port's windowed store against the JAX package's, on the CPU
(``data/device_store.py`` ``WindowStore``).

- windows byte-equal to the JAX package's ``WindowStore`` (on a one-device
  CPU mesh) and to the host loaders over full epochs, the short tail
  window included; the padded tail rows are never sliced;
- a mid-epoch resume is a window plus slice shift;
- one upload a window, window-sized, never one a step;
- the process-local column block for P = 2 and 4 (by ``process_index``,
  no process group), equal to each process's JAX ``EpochLoader`` stream;
- the prefetch thread stages every window after an epoch's first; a jump
  drops the abandoned staged window before staging the next; ``close()``
  stops the worker; a staging error raises on the training thread;
- a memmap-backed dataset is windowable.

Every comparison is bytewise.
"""

import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.data import device_store as jax_store
from simclr_pytorch_distributed_tpu.data.pipeline import EpochLoader as JaxEpochLoader
from simclr_pytorch_distributed_tpu.parallel.mesh import create_mesh
from simclr_pytorch_distributed_tpu_torch.data import device_store
from simclr_pytorch_distributed_tpu_torch.data.device_store import WindowStore
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from torch_threads import limit_threads

limit_threads()

CPU = torch.device("cpu")
PREFETCH_THREAD = "WindowStore-prefetch"


def _dataset(n=70, size=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return images, labels


def _copy_put(log=None):
    """A ``window_put`` that uploads copies and records each window."""
    def put(images, labels):
        out = torch.from_numpy(images.copy()), torch.from_numpy(labels.copy())
        if log is not None:
            log.append((threading.current_thread().name, out))
        return out
    return put


@pytest.mark.parametrize("n,window", [(70, 3), (130, 3), (130, 8)])
def test_windows_byte_equal_to_jax_over_full_epochs(n, window):
    images, labels = _dataset(n=n)
    ours = EpochLoader(images, labels, 16, base_seed=5)
    theirs = JaxEpochLoader(images, labels, 16, base_seed=5)
    mesh1 = create_mesh(jax.devices()[:1])
    store = WindowStore(ours, CPU, window, prefetch=False)
    jstore = jax_store.WindowStore(theirs, mesh1, window, prefetch=False)
    assert (store.window_batches, store.n_windows) == (jstore.window_batches, jstore.n_windows)
    for epoch in (1, 2):
        host = list(ours.epoch(epoch))
        assert len(host) == ours.steps_per_epoch
        for s, (h_imgs, h_labs) in enumerate(host):
            w_imgs, w_labs = store.batch_buffers(epoch, s)
            j_imgs, j_labs = (np.asarray(a) for a in jstore.batch_buffers(epoch, s))
            assert w_imgs.shape[0] == store.window_batches  # one shape for every window
            np.testing.assert_array_equal(w_imgs.numpy(), j_imgs)  # pad rows included
            np.testing.assert_array_equal(w_labs.numpy(), j_labs)
            b_imgs, b_labs = store.batch(epoch, s)
            assert b_imgs.dtype == torch.uint8 and b_labs.dtype == torch.int32
            np.testing.assert_array_equal(b_imgs.numpy(), h_imgs)
            np.testing.assert_array_equal(b_labs.numpy(), h_labs)


def test_padded_tail_is_never_sliced():
    images, labels = _dataset(n=112)  # 7 steps of 16
    loader = EpochLoader(images, labels, 16, base_seed=1)
    store = WindowStore(loader, CPU, 3, prefetch=False)
    tail_window, tail_len = 2, 1
    w_imgs, _ = store.batch_buffers(1, 6)
    # the tail window holds one real batch and two pad rows (its first row)
    np.testing.assert_array_equal(w_imgs[1].numpy(), w_imgs[0].numpy())
    np.testing.assert_array_equal(w_imgs[2].numpy(), w_imgs[0].numpy())
    for gstep in range(3 * loader.steps_per_epoch):
        idx = gstep % loader.steps_per_epoch
        if idx // store.window_batches == tail_window:
            assert idx % store.window_batches < tail_len


def test_mid_epoch_resume_is_a_window_plus_slice_shift():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)  # 8 steps
    uploads = []
    store = WindowStore(loader, CPU, 3, window_put=_copy_put(uploads), prefetch=False)
    epoch, start = 3, 4  # window 1, offset 1
    resumed = list(loader.epoch(epoch, start_step=start))
    for off, (h_imgs, h_labs) in enumerate(resumed):
        b_imgs, b_labs = store.batch(epoch, start + off)
        np.testing.assert_array_equal(b_imgs.numpy(), h_imgs)
        np.testing.assert_array_equal(b_labs.numpy(), h_labs)
    assert len(uploads) == 2  # windows 1 and 2; window 0 was never staged


def test_one_upload_per_window_never_per_step():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)  # 8 steps
    uploads = []
    store = WindowStore(loader, CPU, 4, window_put=_copy_put(uploads), prefetch=False)
    for epoch in (1, 2):
        for idx in range(loader.steps_per_epoch):
            store.batch(epoch, idx)
            store.batch(epoch, idx)  # the same step again: cached
        assert len(uploads) == epoch * store.n_windows == 2 * epoch
    row = images[0].nbytes
    for _, (w_imgs, w_labs) in uploads:
        assert w_imgs.numel() == 4 * 16 * row and w_labs.numel() * 4 == 4 * 16 * 4


@pytest.mark.parametrize("world", [2, 4])
def test_each_process_stages_its_own_column_block(world):
    images, labels = _dataset(n=64)
    per_proc = 16 // world
    for p in range(world):
        uploads = []
        ours = EpochLoader(images, labels, 16, base_seed=3, process_index=p,
                           process_count=world)
        theirs = JaxEpochLoader(images, labels, 16, base_seed=3, process_index=p,
                                process_count=world)
        store = WindowStore(ours, CPU, 2, window_put=_copy_put(uploads), prefetch=False)
        for s, (h_imgs, h_labs) in enumerate(theirs.epoch(5)):
            b_imgs, b_labs = store.batch(5, s)
            assert uploads[-1][1][0].shape == (2, per_proc) + images.shape[1:]
            np.testing.assert_array_equal(b_imgs.numpy(), h_imgs)
            np.testing.assert_array_equal(b_labs.numpy(), h_labs)
        assert len(uploads) == store.n_windows
        # the resident store takes the same columns
        resident = device_store.DeviceStore(ours, CPU)
        for s, (h_imgs, _) in enumerate(ours.epoch(5)):
            np.testing.assert_array_equal(resident.batch(5, s)[0].numpy(), h_imgs)


def test_prefetch_thread_stages_the_next_window():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)  # 8 steps
    staged = []
    store = WindowStore(loader, CPU, 2, window_put=_copy_put(staged))
    try:
        host = list(loader.epoch(1))
        for idx in range(loader.steps_per_epoch):
            np.testing.assert_array_equal(store.batch(1, idx)[0].numpy(), host[idx][0])
    finally:
        store.close()
    names = [name for name, _ in staged]
    assert len(names) == store.n_windows == 4
    assert not names[0].startswith(PREFETCH_THREAD)
    assert all(name.startswith(PREFETCH_THREAD) for name in names[1:])


def test_jump_drops_the_abandoned_window_before_staging():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)
    staged, alive_at_third = [], []

    def slow_put(w_imgs, w_labs):
        if len(staged) == 2:  # the jump's stage: the abandoned window must be gone
            alive_at_third.append([ref() is not None for ref in staged[1]])
        time.sleep(0.15)  # keep the prefetch running when the jump lands
        out = torch.from_numpy(w_imgs.copy()), torch.from_numpy(w_labs.copy())
        staged.append([weakref.ref(t) for t in out])
        return out

    store = WindowStore(loader, CPU, 2, window_put=slow_put)
    try:
        store.batch_buffers(1, 0)  # schedules window (1, 1)
        got = store.batch(3, 0)  # a jump while (1, 1) is staging
    finally:
        store.close()
    assert len(staged) == 3 and alive_at_third == [[False, False]]
    np.testing.assert_array_equal(got[0].numpy(), next(loader.epoch(3))[0])


def test_close_stops_the_prefetch_worker():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)
    store = WindowStore(loader, CPU, 2)
    store.batch_buffers(1, 0)  # schedules the next window
    store.close()
    assert store._executor is None and store._next is None
    for t in threading.enumerate():
        if t.name.startswith(PREFETCH_THREAD):
            t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith(PREFETCH_THREAD))
    # a closed store stages on the calling thread
    np.testing.assert_array_equal(store.batch(1, 2)[0].numpy(), list(loader.epoch(1))[2][0])
    device_store.DeviceStore(loader, CPU).close()  # the shared API, a no-op


def test_staging_error_raises_on_the_training_thread():
    images, labels = _dataset(n=130)
    loader = EpochLoader(images, labels, 16, base_seed=5)
    calls = []

    def failing_put(w_imgs, w_labs):
        calls.append(1)
        if len(calls) > 1:
            raise OSError("simulated staging failure")
        return torch.from_numpy(w_imgs), torch.from_numpy(w_labs)

    store = WindowStore(loader, CPU, 4, window_put=failing_put)
    try:
        store.batch_buffers(1, 0)  # schedules the failing stage
        with pytest.raises(OSError, match="staging failure"):
            store.batch_buffers(1, 4)
    finally:
        store.close()


def test_memmap_is_windowable(tmp_path):
    images, labels = _dataset(n=130)
    np.save(tmp_path / "images.npy", images)
    mm = np.load(tmp_path / "images.npy", mmap_mode="r")
    loader = EpochLoader(mm, labels, 16, base_seed=4)
    budget = device_store.windowed_bytes_per_device(images, labels, 16, 1, 3)
    assert device_store.resolve_data_placement("auto", mm, labels, 16, 1, budget, 3) == "window"
    store = device_store.make_store("auto", loader, CPU, budget, 3)
    assert isinstance(store, WindowStore)
    store.close()
    uploads = []
    store = WindowStore(loader, CPU, 3, window_put=_copy_put(uploads), prefetch=False)
    for s, (h_imgs, h_labs) in enumerate(loader.epoch(1)):
        b_imgs, b_labs = store.batch(1, s)
        np.testing.assert_array_equal(b_imgs.numpy(), h_imgs)
        np.testing.assert_array_equal(b_labs.numpy(), h_labs)
    # each upload is one window's rows, never the dataset
    assert len(uploads) == store.n_windows
    assert all(u[1][0].numel() == 3 * 16 * images[0].nbytes < images.nbytes for u in uploads)
