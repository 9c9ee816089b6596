"""``--dataset path``: a class-per-subdirectory image tree (the reference's
``torchvision.datasets.ImageFolder``, ``main_supcon.py:189-191``) as uint8
arrays.

The port's own copy of the JAX package's ``data/folder.py``: every
immediate subdirectory of the root is a class, sorted by name; images are
decoded once with PIL into ``[N, S, S, 3]`` uint8 at ``store_size`` (2x
the crop size by default), and the random resized crop then runs on the
device from that resolution (``ops/augment.py``). A tree whose decoded size
passes ``mmap_threshold_bytes`` is decoded once into an on-disk ``.npy``
cache, keyed by a manifest hash (paths, sizes, mtimes, resolution), and
returned memory-mapped, so host memory stays bounded by the page cache;
the placement ladder then streams it window by window
(``data/device_store.py``). PIL is imported only when an image is decoded
(a cache hit needs none): where it is absent, ``--dataset path`` raises one
``ImportError`` naming it.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from simclr_pytorch_distributed_tpu_torch.data.cifar import NumpyDataset

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".ppm")

# decoded trees larger than this go through the on-disk memmap cache
DEFAULT_MMAP_THRESHOLD = 1 << 30  # 1 GiB


def find_classes(root: str) -> List[str]:
    """The sorted immediate subdirectories of ``root``: the classes."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    return classes


def _scan_tree(root: str, classes: List[str]) -> Tuple[List[str], List[int]]:
    """Every image path and its class index, in a deterministic sorted order."""
    paths, labels = [], []
    for cls_idx, cls in enumerate(classes):
        for dirpath, _, filenames in sorted(os.walk(os.path.join(root, cls))):
            for fname in sorted(filenames):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    paths.append(os.path.join(dirpath, fname))
                    labels.append(cls_idx)
    if not paths:
        raise FileNotFoundError(f"no images with {IMG_EXTENSIONS} under {root}")
    return paths, labels


def _manifest_key(paths: List[str], store: int) -> str:
    """The decode cache's key: the paths with their sizes and mtimes, and
    the stored resolution."""
    h = hashlib.sha256()
    h.update(str(store).encode())
    for p in paths:
        st = os.stat(p)
        h.update(p.encode())
        h.update(f"{st.st_size}:{int(st.st_mtime)}".encode())
    return h.hexdigest()[:32]


def _pil_image():
    """PIL's ``Image`` module, or one ``ImportError`` that names it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "--dataset path decodes images with PIL (Pillow), which this Python "
            "does not have: install Pillow, or decode the tree elsewhere"
        ) from e
    return Image


def _decode_one(path: str, store: int) -> np.ndarray:
    Image = _pil_image()
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((store, store), Image.BILINEAR),
                          dtype=np.uint8)


def load_image_folder(
    root: str,
    size: int = 32,
    store_size: Optional[int] = None,
    cache_dir: Optional[str] = None,
    mmap_threshold_bytes: int = DEFAULT_MMAP_THRESHOLD,
) -> Tuple[NumpyDataset, List[str]]:
    """``({'images': uint8 [N, S, S, 3], 'labels': int32 [N]}, classes)``
    for the tree under ``root``; ``S`` is ``store_size`` or ``2 * size``.
    Above ``mmap_threshold_bytes`` of decoded data the images are a
    read-only memmap of a cache file under ``cache_dir`` (default
    ``<tempdir>/sptpu_folder_cache``)."""
    s = store_size or 2 * size
    classes = find_classes(root)
    paths, labels = _scan_tree(root, classes)
    labels_arr = np.asarray(labels, np.int32)
    n = len(paths)

    if n * s * s * 3 <= mmap_threshold_bytes:
        images = np.stack([_decode_one(p, s) for p in paths])
        return {"images": images, "labels": labels_arr}, classes

    cache_root = cache_dir or os.path.join(tempfile.gettempdir(), "sptpu_folder_cache")
    os.makedirs(cache_root, exist_ok=True)
    key = _manifest_key(paths, s)
    arr_path = os.path.join(cache_root, f"{key}.npy")
    meta_path = os.path.join(cache_root, f"{key}.json")
    # a hit is the array file alone: os.replace commits it whole, and the
    # json beside it is for people, never read here
    if not os.path.exists(arr_path):
        _pil_image()  # before a cache file is opened
        # a temp name of this process's own: two decoders of one tree each
        # write their file, and os.replace commits one whole
        fd, tmp_path = tempfile.mkstemp(suffix=".npy.tmp", dir=cache_root)
        os.close(fd)
        out = np.lib.format.open_memmap(tmp_path, mode="w+", dtype=np.uint8, shape=(n, s, s, 3))
        for i, p in enumerate(paths):
            out[i] = _decode_one(p, s)
        out.flush()
        del out
        os.replace(tmp_path, arr_path)
        fd, meta_tmp = tempfile.mkstemp(suffix=".json.tmp", dir=cache_root)
        with os.fdopen(fd, "w") as f:
            json.dump({"n": n, "store": s, "root": os.path.abspath(root)}, f)
        os.replace(meta_tmp, meta_path)
    return {"images": np.load(arr_path, mmap_mode="r"), "labels": labels_arr}, classes
