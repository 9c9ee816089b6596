"""The port's resident store and placement ladder against the JAX
package's, on the CPU (``data/device_store.py``).

- ``DeviceStore`` batches byte-equal to the JAX package's ``EpochLoader``
  and ``DeviceStore`` (on a one-device CPU mesh) over two epochs, and to
  the port's own loader; a mid-epoch resume is a slice shift; one index
  upload an epoch, of the ``[steps, batch]`` int32 matrix;
- ``resident_bytes_per_device``, ``windowed_bytes_per_device`` and
  ``epoch_index_matrix`` equal to JAX's;
- the ladder's verdict, its banner and its refusal equal to JAX's
  ``resolve_data_placement`` over one grid (placement x budget x memmap),
  and the collective call count per resolution;
- bad geometry refused; the budget from ``torch.cuda.mem_get_info``;
- two gloo processes (``tests/torch_parallel_child.py`` suite
  ``placement``): a lower budget on one process sends both to the same
  rung, an explicit ``device`` over one's budget raises on both, and each
  process's store serves its own column block.

Every comparison is bytewise.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.data import device_store as jax_store
from simclr_pytorch_distributed_tpu.data.pipeline import EpochLoader as JaxEpochLoader
from simclr_pytorch_distributed_tpu.parallel.mesh import create_mesh
from simclr_pytorch_distributed_tpu_torch.data import device_store
from simclr_pytorch_distributed_tpu_torch.data.device_store import (
    DeviceStore,
    WindowStore,
    epoch_index_matrix,
    resolve_data_placement,
)
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from torch_threads import limit_threads

limit_threads()

CPU = torch.device("cpu")
PORT_LOGGER = "simclr_pytorch_distributed_tpu_torch.data.device_store"
JAX_LOGGER = "simclr_pytorch_distributed_tpu.data.device_store"


def _dataset(n=70, size=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def mesh1():
    return create_mesh(jax.devices()[:1])


def test_batches_byte_equal_to_jax_over_two_epochs(mesh1):
    images, labels = _dataset()
    ours = EpochLoader(images, labels, 16, base_seed=5)
    theirs = JaxEpochLoader(images, labels, 16, base_seed=5)
    store, jstore = DeviceStore(ours, CPU), jax_store.DeviceStore(theirs, mesh1)
    for epoch in (1, 2):
        j_imgs, j_labs = (np.asarray(a) for a in jstore.epoch_buffers(epoch))
        host = list(ours.epoch(epoch))
        assert len(host) == ours.steps_per_epoch == 4
        for s, ((h_imgs, h_labs), (t_imgs, t_labs)) in enumerate(zip(host, theirs.epoch(epoch))):
            b_imgs, b_labs = store.batch(epoch, s)
            assert b_imgs.dtype == torch.uint8 and b_labs.dtype == torch.int32
            for got in (b_imgs.numpy(), j_imgs[s], t_imgs):
                np.testing.assert_array_equal(got, h_imgs)
            for got in (b_labs.numpy(), j_labs[s], t_labs):
                np.testing.assert_array_equal(got, h_labs)


def test_mid_epoch_resume_is_a_slice_shift():
    images, labels = _dataset()
    loader = EpochLoader(images, labels, 16, base_seed=5)
    store = DeviceStore(loader, CPU)
    epoch, start = 3, 2
    resumed = list(loader.epoch(epoch, start_step=start))
    assert len(resumed) == loader.steps_per_epoch - start
    for off, (h_imgs, h_labs) in enumerate(resumed):
        b_imgs, b_labs = store.batch(epoch, start + off)
        np.testing.assert_array_equal(b_imgs.numpy(), h_imgs)
        np.testing.assert_array_equal(b_labs.numpy(), h_labs)
    with pytest.raises(ValueError, match="start_step"):
        loader.check_start_step(loader.steps_per_epoch)


def test_one_index_upload_per_epoch():
    images, labels = _dataset()
    loader = EpochLoader(images, labels, 16, base_seed=5)
    uploads = []

    def counting_put(idx):
        uploads.append((idx.shape, idx.dtype, idx.nbytes))
        return torch.from_numpy(idx)

    store = DeviceStore(loader, CPU, index_put=counting_put)
    for idx in range(loader.steps_per_epoch):
        store.batch(1, idx)
    assert len(uploads) == 1
    first = store.epoch_buffers(2)
    assert len(uploads) == 2 and store.epoch_buffers(2) is first  # cached, no regather
    # the transfer is the [steps, batch] int32 matrix, not the data
    assert uploads[0] == ((4, 16), np.int32, 4 * 16 * 4)


@pytest.mark.parametrize("n,batch,dp,window", [(70, 16, 1, 3), (70, 16, 8, 4), (130, 16, 2, 99),
                                                (64, 8, 4, 2)])
def test_byte_accounting_and_index_matrix_equal_jax(n, batch, dp, window):
    images, labels = _dataset(n=n)
    assert (device_store.resident_bytes_per_device(images, labels, batch, dp)
            == jax_store.resident_bytes_per_device(images, labels, batch, dp))
    assert (device_store.windowed_bytes_per_device(images, labels, batch, dp, window)
            == jax_store.windowed_bytes_per_device(images, labels, batch, dp, window))
    ours = epoch_index_matrix(EpochLoader(images, labels, batch, base_seed=4), 3)
    theirs = jax_store.epoch_index_matrix(JaxEpochLoader(images, labels, batch, base_seed=4), 3)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)


def _resolve(fn, logger_name, caplog, *args, **kwargs):
    """``(verdict or None, the ValueError's text or None, the log lines)``."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger_name):
        try:
            got, err = fn(*args, **kwargs), None
        except ValueError as e:
            got, err = None, str(e)
    return got, err, [r.getMessage() for r in caplog.records if r.name == logger_name]


W = 2
_IMAGES, _LABELS = _dataset(n=130)
NEED_RES = device_store.resident_bytes_per_device(_IMAGES, _LABELS, 16, 1)
NEED_WIN = device_store.windowed_bytes_per_device(_IMAGES, _LABELS, 16, 1, W)
BUDGETS = {"fits": NEED_RES, "window_only": (NEED_RES + NEED_WIN) // 2, "tiny": 10}


@pytest.mark.parametrize("memmap", [False, True])
@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("placement", ["auto", "device", "window", "host"])
def test_ladder_verdict_and_banner_equal_jax(placement, budget, memmap, mesh1, caplog, tmp_path):
    images, labels = _IMAGES, _LABELS
    if memmap:
        np.save(tmp_path / "images.npy", images)
        images = np.load(tmp_path / "images.npy", mmap_mode="r")
    kwargs = dict(budget_bytes=BUDGETS[budget], window_batches=W)
    ours = _resolve(resolve_data_placement, PORT_LOGGER, caplog, placement, images, labels, 16,
                    data_parallel=1, **kwargs)
    theirs = _resolve(jax_store.resolve_data_placement, JAX_LOGGER, caplog, placement, images,
                      labels, 16, mesh1, **kwargs)
    assert ours == theirs
    verdict, err, _ = ours
    expected = {"host": "host", "device": "device", "window": "window"}
    if placement == "auto":
        assert verdict == ("device" if budget == "fits" and not memmap
                           else "window" if budget != "tiny" else "host")
    elif placement == "device" and (memmap or budget != "fits"):
        assert "cannot be satisfied" in err
    elif placement == "window" and budget == "tiny":
        assert "cannot be satisfied" in err
    else:
        assert verdict == expected[placement]


def test_unknown_placement_and_bad_geometry_are_refused():
    images, labels = _dataset()
    with pytest.raises(ValueError, match="unknown data_placement"):
        resolve_data_placement("hbm", images, labels, 16)
    ragged = EpochLoader(images, labels, 16, drop_last=False)
    assert ragged.steps_per_epoch == 5  # the ragged tail counts as a step
    for build in (lambda: DeviceStore(ragged, CPU), lambda: WindowStore(ragged, CPU, 2)):
        with pytest.raises(ValueError, match="drop_last"):
            build()
    with pytest.raises(ValueError, match="window_batches"):
        WindowStore(EpochLoader(images, labels, 16), CPU, 0)
    # a window longer than the epoch is clamped to it
    assert WindowStore(EpochLoader(images, labels, 16), CPU, 99).window_batches == 4


def test_make_store_builds_the_verdict(tmp_path):
    images, labels = _IMAGES, _LABELS
    loader = EpochLoader(images, labels, 16, base_seed=3)
    assert isinstance(device_store.make_store("auto", loader, CPU, BUDGETS["fits"]), DeviceStore)
    store = device_store.make_store("auto", loader, CPU, BUDGETS["window_only"], W)
    assert isinstance(store, WindowStore) and store.loader is loader and store.window_batches == W
    assert device_store.make_store("auto", loader, CPU, BUDGETS["tiny"]) is None
    assert device_store.make_store("host", loader, CPU) is None
    # the loader's ascontiguousarray of a memmap is a view of it: never resident
    np.save(tmp_path / "images.npy", images)
    mm = EpochLoader(np.load(tmp_path / "images.npy", mmap_mode="r"), labels, 16, base_seed=3)
    assert not isinstance(mm.images, np.memmap) and device_store._is_memmap_backed(mm.images)
    assert isinstance(device_store.make_store("auto", mm, CPU, 1 << 30, W), WindowStore)


def test_device_budget_reads_free_memory(monkeypatch):
    assert device_store.device_budget_bytes(CPU) == device_store.DEFAULT_BUDGET_BYTES
    assert device_store.device_budget_bytes() == device_store.DEFAULT_BUDGET_BYTES
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (1000, 4000))
    assert device_store.device_budget_bytes(torch.device("cuda", 0)) == 400
    assert device_store.budget_override_bytes(0) is None
    assert device_store.budget_override_bytes(3) == 3 << 20


@pytest.mark.parametrize("placement,budget", [("auto", "fits"), ("auto", "tiny"),
                                              ("device", "fits"), ("window", "fits")])
def test_collective_call_count_equals_jax(placement, budget, monkeypatch, mesh1):
    """With a peer rejecting every rung, each resolution enters the agreement
    once for an explicit placement and once per rung under 'auto', with the
    local verdict, as JAX's does; the outcome (host or the raise) is JAX's."""
    calls = {"ours": [], "theirs": []}

    def peer_disagrees(key):
        def agree(local_ok):
            calls[key].append(local_ok)
            return False
        return agree

    monkeypatch.setattr(device_store, "_agree_across_processes", peer_disagrees("ours"))
    monkeypatch.setattr(jax_store, "_agree_across_processes", peer_disagrees("theirs"))
    outcomes = []
    for fn, extra in ((resolve_data_placement, {"data_parallel": 1}),
                      (jax_store.resolve_data_placement, {"mesh": mesh1})):
        try:
            outcomes.append(fn(placement, _IMAGES, _LABELS, 16, budget_bytes=BUDGETS[budget],
                               window_batches=W, **extra))
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert calls["ours"] == calls["theirs"] and calls["ours"]


def test_two_processes_agree_on_the_rung(tmp_path):
    ranks = child.spawn(2, tmp_path / "world2", "placement")
    assert [r["auto_mixed"] for r in ranks] == ["window", "window"]
    assert [r["auto_host"] for r in ranks] == ["host", "host"]
    assert all("cannot be satisfied" in r["device_error"] for r in ranks)
    assert "peer process" in ranks[0]["device_error"]  # rank 0 fit; rank 1 did not
    images, labels = child.placement_dataset()
    for rank, r in enumerate(ranks):
        assert r["store"] == "WindowStore"
        theirs = JaxEpochLoader(images, labels, child.PLACEMENT_BATCH, base_seed=2,
                                process_index=rank, process_count=2)
        want = [b for epoch in (1, 2) for b in theirs.epoch(epoch)]
        assert len(r["batches"]) == len(want)
        for (g_imgs, g_labs), (w_imgs, w_labs) in zip(r["batches"], want):
            np.testing.assert_array_equal(g_imgs, w_imgs)
            np.testing.assert_array_equal(g_labs, w_labs)
