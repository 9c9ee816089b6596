"""Datasets: CIFAR-10/100 from local python pickles, and the synthetic sets.

The same arrays as ``simclr_pytorch_distributed_tpu/data/cifar.py`` (its
numpy code, kept here as the port's own copy): images come back NHWC
``uint8``, labels ``int32``. CIFAR is read from the canonical
``cifar-10-batches-py`` / ``cifar-100-python`` layout under
``data_folder``; nothing is downloaded.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

NumpyDataset = Dict[str, np.ndarray]  # images [N, H, W, 3] u8, labels [N] i32


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


DATASETS = ("cifar10", "cifar100", "synthetic", "synthetic_hard", "synthetic_hard32")


def load_dataset(dataset: str, data_folder: str) -> Tuple[NumpyDataset, NumpyDataset, int]:
    """``(train, test, num_classes)`` for one of :data:`DATASETS`."""
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
        raise FileNotFoundError(
            f"{marker} not found under {data_folder}: place the python version "
            f"of {dataset} there, or pass --dataset synthetic"
        )
    return (*loader(data_folder), n_cls)
