"""The port's native host gather (``data/native_gather.py``,
``csrc/gather.cpp``) against numpy and the JAX package's
``data/pipeline._gather``, on the CPU.

- Bytewise equal to numpy's fancy indexing and to the JAX package's gather,
  for C-contiguous and non-contiguous images, int32 and int64 labels, and
  the window store's 2-D index matrices; labels come back int32.
- The native path counts its calls (``native_calls``); the numpy path
  (non-contiguous images, or no library) does not.
- Without ``g++`` the numpy path runs, and the path is logged once.
- ``EpochLoader`` and ``WindowStore`` gather through it: their batches are
  the JAX loader's bytes and the counter moves.
"""

import logging

import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.data import pipeline as jax_pipeline
from simclr_pytorch_distributed_tpu_torch.data import native_gather
from simclr_pytorch_distributed_tpu_torch.data.device_store import WindowStore
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from torch_threads import limit_threads

limit_threads()


def _data(label_dtype=np.int32, n=57):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (n, 5, 6, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(label_dtype)
    return images, labels


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("contiguous", [True, False])
def test_gather_is_numpy_and_jax_bytewise(label_dtype, contiguous):
    images, labels = _data(label_dtype)
    if not contiguous:
        images = images[:, :, ::2]  # a strided view: numpy's path
    assert images.flags["C_CONTIGUOUS"] == contiguous
    sel = np.random.default_rng(1).permutation(len(images))[:20]
    before = native_gather.native_calls
    got_img, got_lab = native_gather.gather(images, labels, sel)
    assert (native_gather.native_calls - before) == (1 if contiguous else 0)
    _same(got_img, images[sel])
    _same(got_lab, labels[sel].astype(np.int32))
    jax_img, jax_lab = jax_pipeline._gather(images, labels, sel)
    _same(got_img, np.asarray(jax_img))
    _same(got_lab, np.asarray(jax_lab).astype(np.int32))


def test_gather_takes_an_index_matrix():
    images, labels = _data(np.int64)
    rows = np.random.default_rng(2).integers(0, len(images), (3, 4))
    got_img, got_lab = native_gather.gather(images, labels, rows)
    _same(got_img, images[rows])
    _same(got_lab, labels[rows].astype(np.int32))


def test_numpy_path_without_a_compiler_is_logged_once(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native_gather, "_lib", None)
    monkeypatch.setattr(native_gather, "_tried", False)
    monkeypatch.setattr(native_gather, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_gather.shutil, "which", lambda name: None)
    images, labels = _data()
    before = native_gather.native_calls
    with caplog.at_level(logging.INFO):
        for _ in range(3):
            got_img, got_lab = native_gather.gather(images, labels, np.arange(7))
    _same(got_img, images[:7])
    _same(got_lab, labels[:7])
    assert native_gather.native_calls == before
    assert caplog.text.count("native gather unavailable") == 1
    assert "g++ not found" in caplog.text


def test_library_builds_under_a_source_hash():
    path = native_gather.library_path()
    assert path.parent == native_gather.BUILD_DIR
    assert path.name.startswith("libgather_") and path.suffix == ".so"
    if native_gather.load() is not None:  # a host with g++
        assert path.is_file()


def test_loaders_gather_natively_and_match_jax():
    images, labels = _data(np.int64, n=64)
    ours = EpochLoader(images, labels, 8, base_seed=3)
    theirs = jax_pipeline.EpochLoader(images, labels, 8, base_seed=3)
    before = native_gather.native_calls
    for (gi, gl), (ri, rl) in zip(ours.epoch(1), theirs.epoch(1)):
        _same(gi, np.asarray(ri))
        _same(gl, np.asarray(rl).astype(np.int32))
    if native_gather.load() is not None:
        assert native_gather.native_calls - before == len(ours)
    store = WindowStore(ours, torch.device("cpu"), window_batches=3, prefetch=False)
    try:
        before = native_gather.native_calls
        host = list(ours.epoch(2))
        for idx in range(len(ours)):
            img, lab = store.batch(2, idx)
            _same(img.numpy(), host[idx][0])
            _same(lab.numpy(), host[idx][1])
        if native_gather.load() is not None:
            # the epoch's batches, and one gather a window (3 windows)
            assert native_gather.native_calls - before == len(ours) + 3
    finally:
        store.close()
