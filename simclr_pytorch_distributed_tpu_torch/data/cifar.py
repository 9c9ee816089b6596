"""Datasets: CIFAR-10/100 from local python pickles (fetched when absent),
the synthetic sets, and class-per-subdirectory image trees.

The same arrays as ``simclr_pytorch_distributed_tpu/data/cifar.py`` (its
numpy code, kept here as the port's own copy): images come back NHWC
``uint8``, labels ``int32``. CIFAR is read from the canonical
``cifar-10-batches-py`` / ``cifar-100-python`` layout under
``data_folder``. When it is absent, :func:`ensure_dataset_available` (the
drivers call it first, unless ``--no_download``) fetches the archive the
reference's torchvision ``download=True`` fetches (``main_supcon.py:181-188``;
JAX ``cifar.py:46-363``): md5-checked, retried with backoff, extracted into
a staging directory and renamed into place, one downloader per filesystem
under an ``flock``. ``--dataset path`` reads an image tree
(``data/folder.py``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import shutil
import tarfile
from typing import Dict, Optional, Tuple

import numpy as np

NumpyDataset = Dict[str, np.ndarray]  # images [N, H, W, 3] u8, labels [N] i32

# The archives torchvision fetches: (archive name, md5, extracted directory).
CIFAR_ARCHIVES = {
    "cifar10": ("cifar-10-python.tar.gz", "c58f30108f718f92721af3b95e74349a",
                "cifar-10-batches-py"),
    "cifar100": ("cifar-100-python.tar.gz", "eb9058c3a382ffc7106e4002c42a8d85",
                 "cifar-100-python"),
}
CIFAR_BASE_URL = "https://www.cs.toronto.edu/~kriz"
DOWNLOAD_ATTEMPTS = 3
DOWNLOAD_BACKOFF_BASE = 0.5  # seconds; doubles each attempt, plus jitter
# how long a process waits for another's download lock before going on
LOCK_WAIT_SECONDS = 3600.0


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _extract(archive: str, root: str, marker: str, fname: str) -> None:
    """Extract into a staging directory of this process's own, then rename
    the marker directory into place: its presence means a whole tree."""
    stage = os.path.join(root, f".extract.{os.getpid()}")
    try:
        os.makedirs(stage, exist_ok=True)
        with tarfile.open(archive, "r:gz") as tar:
            # the 'data' filter refuses absolute paths, '..' and links
            tar.extractall(stage, filter="data")
        staged = os.path.join(stage, marker)
        if not os.path.isdir(staged):
            raise FileNotFoundError(f"{fname} extracted but {marker} did not appear under {stage}")
        try:
            os.rename(staged, os.path.join(root, marker))
        except OSError:
            if not os.path.isdir(os.path.join(root, marker)):  # not a lost race
                raise
    finally:
        shutil.rmtree(stage, ignore_errors=True)


def download_cifar(
    dataset: str,
    data_folder: str,
    base_url: Optional[str] = None,
    md5: Optional[str] = None,
    timeout: float = 60.0,
    attempts: int = DOWNLOAD_ATTEMPTS,
    backoff_base: float = DOWNLOAD_BACKOFF_BASE,
) -> str:
    """Fetch, check and extract a CIFAR archive; returns the extracted
    directory. An extracted directory, or an archive already there with the
    right md5, short-circuits. The fetch is tried ``attempts`` times with
    exponential backoff and jitter; an md5 mismatch (a truncated transfer,
    usually) is retried too, each attempt into a fresh temporary file.
    ``base_url`` and ``md5`` let tests serve a local archive."""
    import random
    import time
    import urllib.request

    if dataset not in CIFAR_ARCHIVES:
        raise ValueError(f"no download recipe for dataset {dataset!r}")
    fname, want_md5, marker = CIFAR_ARCHIVES[dataset]
    want_md5 = md5 or want_md5
    root = os.path.abspath(data_folder)
    os.makedirs(root, exist_ok=True)
    marker_dir = os.path.join(root, marker)
    if os.path.isdir(marker_dir):
        return marker_dir
    archive = os.path.join(root, fname)
    if not (os.path.exists(archive) and _md5(archive) == want_md5):
        url = f"{base_url or CIFAR_BASE_URL}/{fname}"
        tmp = archive + f".partial.{os.getpid()}"
        for attempt in range(1, max(1, attempts) + 1):
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
                    shutil.copyfileobj(r, f)
                got = _md5(tmp)
                if got != want_md5:
                    raise ValueError(f"md5 mismatch for {url}: got {got}, want {want_md5}")
                os.replace(tmp, archive)  # no torn archive on the hit path
                break
            except Exception as e:  # noqa: BLE001 — URLError, timeout, md5: retried
                if attempt >= max(1, attempts):
                    raise
                delay = backoff_base * (2 ** (attempt - 1))
                delay += random.uniform(0, delay / 2)  # jitter: waiters desync
                logging.warning("download attempt %d/%d for %s failed (%s); retrying "
                                "in %.1fs", attempt, attempts, url, e, delay)
                time.sleep(delay)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    if not os.path.isdir(marker_dir):  # else another caller extracted it meanwhile
        _extract(archive, root, marker, fname)
    return marker_dir


def maybe_download(dataset: str, data_folder: Optional[str]) -> None:
    """Fetch CIFAR when its directory is absent; a failure is a warning,
    and :func:`load_dataset` then raises for the missing files."""
    if dataset not in CIFAR_ARCHIVES or not data_folder:
        return
    if os.path.isdir(os.path.join(data_folder, CIFAR_ARCHIVES[dataset][2])):
        return
    try:
        download_cifar(dataset, data_folder)
        logging.info("downloaded %s into %s", dataset, data_folder)
    except Exception as e:  # noqa: BLE001 — URLError, timeout, md5
        logging.warning("could not download %s: %s", dataset, e)


def ensure_dataset_available(dataset: str, data_folder: Optional[str],
                             download: bool = True) -> None:
    """Download CIFAR if absent, once per filesystem, then a barrier.

    Every process takes an ``flock`` on ``.{dataset}.download.lock`` in the
    data folder and downloads, checks and extracts while holding it, so the
    next holder sees the finished directory. The kernel drops the lock of a
    killed holder, so a leftover file blocks nobody; the file is never
    unlinked (that would race a new holder). A process that waits
    :data:`LOCK_WAIT_SECONDS` in vain warns and goes on, and
    :func:`load_dataset` raises if the files are still missing. Then all
    processes meet (``mesh.sync_processes``)."""
    if not download or dataset not in CIFAR_ARCHIVES or not data_folder:
        return
    import fcntl
    import time

    from simclr_pytorch_distributed_tpu_torch.parallel.mesh import sync_processes

    marker = os.path.join(data_folder, CIFAR_ARCHIVES[dataset][2])
    if not os.path.isdir(marker):
        os.makedirs(data_folder, exist_ok=True)
        lock = os.path.join(data_folder, f".{dataset}.download.lock")
        fd = os.open(lock, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            deadline = time.time() + LOCK_WAIT_SECONDS
            acquired = False
            while time.time() < deadline:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    acquired = True
                    break
                except OSError:
                    time.sleep(2)
            if acquired:
                try:
                    os.ftruncate(fd, 0)
                    os.write(fd, f"{os.getpid()} {time.time():.0f}\n".encode())
                    if not os.path.isdir(marker):  # again, under the lock
                        maybe_download(dataset, data_folder)
                finally:
                    fcntl.flock(fd, fcntl.LOCK_UN)
            else:
                try:
                    holder = os.pread(fd, 64, 0).decode("ascii", "replace")
                except OSError:
                    holder = "?"
                logging.warning("gave up waiting for %s after %.0fs; proceeding without "
                                "download (holder pid/time: %s)", lock, LOCK_WAIT_SECONDS,
                                holder.strip() or "?")
        finally:
            os.close(fd)
    sync_processes("dataset_ready")


def _decode_rows(data: np.ndarray) -> np.ndarray:
    return data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_cifar10(data_folder: str) -> Tuple[NumpyDataset, NumpyDataset]:
    root = os.path.join(data_folder, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        d = _load_pickle(os.path.join(root, f"data_batch_{i}"))
        xs.append(_decode_rows(np.asarray(d["data"], np.uint8)))
        ys.append(np.asarray(d["labels"], np.int32))
    t = _load_pickle(os.path.join(root, "test_batch"))
    train = {"images": np.concatenate(xs), "labels": np.concatenate(ys)}
    test = {
        "images": _decode_rows(np.asarray(t["data"], np.uint8)),
        "labels": np.asarray(t["labels"], np.int32),
    }
    return train, test


def load_cifar100(data_folder: str) -> Tuple[NumpyDataset, NumpyDataset]:
    root = os.path.join(data_folder, "cifar-100-python")
    out = []
    for split in ("train", "test"):
        d = _load_pickle(os.path.join(root, split))
        out.append({
            "images": _decode_rows(np.asarray(d["data"], np.uint8)),
            "labels": np.asarray(d["fine_labels"], np.int32),
        })
    return out[0], out[1]


def synthetic_dataset(
    n: int = 2048, num_classes: int = 10, seed: int = 0, size: int = 32
) -> Tuple[NumpyDataset, NumpyDataset]:
    """Class-conditional random images (class color means plus noise)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    class_means = rng.uniform(48, 208, size=(num_classes, 1, 1, 3))
    noise = rng.normal(0, 32, size=(n, size, size, 3))
    images = np.clip(class_means[labels] + noise, 0, 255).astype(np.uint8)
    k = max(n // 8, 1)
    return (
        {"images": images[k:], "labels": labels[k:]},
        {"images": images[:k], "labels": labels[:k]},
    )


def synthetic_texture_dataset(
    n: int = 14336, num_classes: int = 10, seed: int = 0, size: int = 32
) -> Tuple[NumpyDataset, NumpyDataset]:
    """Class-by-texture plaids: class k superimposes gratings at theta_k and
    pi - theta_k, so the class survives the augmentations (a horizontal flip
    swaps the two gratings) while color carries no signal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    xx = xx.astype(np.float32)[None]
    yy = yy.astype(np.float32)[None]
    theta = (labels + 0.5) * (np.pi / 2) / num_classes
    cos_t = np.cos(theta)[:, None, None]
    sin_t = np.sin(theta)[:, None, None]
    freq = rng.uniform(2.5, 3.5, size=(n, 1, 1)) * (2 * np.pi / size)
    phase1 = rng.uniform(0, 2 * np.pi, size=(n, 1, 1))
    phase2 = rng.uniform(0, 2 * np.pi, size=(n, 1, 1))
    wave = np.sin(freq * (cos_t * xx + sin_t * yy) + phase1) + np.sin(
        freq * (-cos_t * xx + sin_t * yy) + phase2
    )
    base = rng.uniform(80, 176, size=(n, 1, 1, 3))
    gain = rng.uniform(16, 32, size=(n, 1, 1, 3))
    img = base + gain * wave[..., None] + rng.normal(0, 10, size=(n, size, size, 3))
    images = np.clip(img, 0, 255).astype(np.uint8)
    k = max(n // 8, 1)
    return (
        {"images": images[k:], "labels": labels[k:]},
        {"images": images[:k], "labels": labels[:k]},
    )


DATASETS = ("cifar10", "cifar100", "synthetic", "synthetic_hard", "synthetic_hard32", "path")


def load_dataset(
    dataset: str,
    data_folder: str,
    allow_synthetic_fallback: bool = False,
    size: int = 32,
    store_size: int = 0,
    mmap_threshold_mb: int = 1024,
) -> Tuple[NumpyDataset, NumpyDataset, int]:
    """``(train, test, num_classes)`` for one of :data:`DATASETS`.

    ``path`` reads the image tree under ``data_folder`` (``data/folder.py``:
    crop ``size``, ``store_size`` 0 for twice that, the memmap cache above
    ``mmap_threshold_mb``) as the train split, with an empty test split, as
    the reference has none there. With ``allow_synthetic_fallback`` a
    missing CIFAR directory gives the synthetic set, with a warning."""
    if dataset == "path":
        from simclr_pytorch_distributed_tpu_torch.data.folder import load_image_folder

        train, classes = load_image_folder(
            data_folder, size=size, store_size=store_size or None,
            mmap_threshold_bytes=mmap_threshold_mb << 20,
        )
        empty = {"images": train["images"][:0], "labels": train["labels"][:0]}
        return train, empty, len(classes)
    if dataset == "synthetic":
        return (*synthetic_dataset(), 10)
    if dataset == "synthetic_hard":
        return (*synthetic_texture_dataset(), 10)
    if dataset == "synthetic_hard32":
        return (*synthetic_texture_dataset(num_classes=32), 32)
    if dataset == "cifar10":
        n_cls, loader, marker = 10, load_cifar10, "cifar-10-batches-py"
    elif dataset == "cifar100":
        n_cls, loader, marker = 100, load_cifar100, "cifar-100-python"
    else:
        raise ValueError(f"dataset not supported: {dataset}")
    if not os.path.isdir(os.path.join(data_folder, marker)):
        if allow_synthetic_fallback:
            logging.warning("%s not found under %s — falling back to synthetic data",
                            marker, data_folder)
            return (*synthetic_dataset(num_classes=n_cls), n_cls)
        raise FileNotFoundError(
            f"{marker} not found under {data_folder}: place the python version "
            f"of {dataset} there (without --no_download the drivers fetch it), or "
            f"pass --dataset synthetic"
        )
    return (*loader(data_folder), n_cls)
