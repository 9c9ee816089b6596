"""The port's ``--dataset path`` reader against the JAX package's, on the
CPU (``data/folder.py``): on a small PNG tree the images, labels and
classes are byte-equal to JAX ``load_image_folder`` at the default and an
explicit ``store_size``; an empty root raises as JAX's does; above the
threshold both decode into a memmap cache under the same manifest key, a
second load hits it (the array file untouched), and a changed image makes
a new entry; ``load_dataset("path")`` gives the tree and an empty test
split; without PIL the decode raises one ``ImportError`` naming it.
"""

import builtins
import os

import numpy as np
import pytest
from PIL import Image

from simclr_pytorch_distributed_tpu.data import cifar as jax_cifar
from simclr_pytorch_distributed_tpu.data import folder as jax_folder
from simclr_pytorch_distributed_tpu_torch.data import folder
from simclr_pytorch_distributed_tpu_torch.data.cifar import load_dataset
from torch_threads import limit_threads

limit_threads()


@pytest.fixture
def image_tree(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "tree"
    for cls, n in {"cats": 3, "dogs": 2}.items():
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
                d / f"img_{i}.png")
    (root / "dogs" / "sub").mkdir()
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).save(
        root / "dogs" / "sub" / "deep.png")
    (root / "notes.txt").write_text("not an image")
    return root


def _assert_equal(ours, theirs):
    (o, o_cls), (t, t_cls) = ours, theirs
    assert o_cls == t_cls
    assert o["images"].dtype == np.uint8 and o["labels"].dtype == np.int32
    np.testing.assert_array_equal(np.asarray(o["images"]), np.asarray(t["images"]))
    np.testing.assert_array_equal(o["labels"], t["labels"])


@pytest.mark.parametrize("store_size", [None, 24])
def test_arrays_equal_jax(image_tree, store_size):
    ours = folder.load_image_folder(str(image_tree), size=16, store_size=store_size)
    _assert_equal(ours, jax_folder.load_image_folder(str(image_tree), size=16,
                                                     store_size=store_size))
    data, classes = ours
    assert classes == ["cats", "dogs"] == folder.find_classes(str(image_tree))
    assert data["images"].shape == (6, store_size or 32, store_size or 32, 3)
    np.testing.assert_array_equal(np.bincount(data["labels"]), [3, 3])


def test_empty_root_raises_like_jax(tmp_path):
    for load in (folder.load_image_folder, jax_folder.load_image_folder):
        with pytest.raises(FileNotFoundError, match="no class subdirectories"):
            load(str(tmp_path))
    (tmp_path / "cls_a").mkdir()
    for load in (folder.load_image_folder, jax_folder.load_image_folder):
        with pytest.raises(FileNotFoundError, match="no images"):
            load(str(tmp_path))


def test_memmap_cache_equals_jax(image_tree, tmp_path):
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours = folder.load_image_folder(str(image_tree), size=16, cache_dir=str(ours_dir),
                                    mmap_threshold_bytes=1)
    theirs = jax_folder.load_image_folder(str(image_tree), size=16, cache_dir=str(theirs_dir),
                                          mmap_threshold_bytes=1)
    assert isinstance(ours[0]["images"], np.memmap)
    _assert_equal(ours, theirs)
    _assert_equal(ours, folder.load_image_folder(str(image_tree), size=16))  # the in-RAM path
    # one cache entry each, under the same manifest key
    npys = sorted(p.name for p in ours_dir.glob("*.npy"))
    assert npys == sorted(p.name for p in theirs_dir.glob("*.npy")) and len(npys) == 1
    paths, _ = folder._scan_tree(str(image_tree), folder.find_classes(str(image_tree)))
    assert npys[0] == folder._manifest_key(paths, 32) + ".npy"
    assert folder._manifest_key(paths, 32) == jax_folder._manifest_key(paths, 32)
    # a hit: the array file is not rewritten
    mtime = (ours_dir / npys[0]).stat().st_mtime_ns
    _assert_equal(folder.load_image_folder(str(image_tree), size=16, cache_dir=str(ours_dir),
                                           mmap_threshold_bytes=1), theirs)
    assert (ours_dir / npys[0]).stat().st_mtime_ns == mtime
    assert not list(ours_dir.glob("*.tmp"))
    # a changed image changes the key
    img = image_tree / "cats" / "img_0.png"
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(img)
    os.utime(img, (0, 0))
    folder.load_image_folder(str(image_tree), size=16, cache_dir=str(ours_dir),
                             mmap_threshold_bytes=1)
    assert len(list(ours_dir.glob("*.npy"))) == 2


def test_load_dataset_path(image_tree):
    train, test, n_cls = load_dataset("path", str(image_tree), size=8, store_size=12)
    j_train, j_test, j_cls = jax_cifar.load_dataset("path", str(image_tree), size=8,
                                                    store_size=12)
    assert n_cls == j_cls == 2
    assert train["images"].shape == (6, 12, 12, 3) and len(test["images"]) == 0
    assert test["images"].shape[1:] == train["images"].shape[1:]
    np.testing.assert_array_equal(train["images"], j_train["images"])
    np.testing.assert_array_equal(test["labels"], j_test["labels"])


def test_without_pil_the_decode_names_it(image_tree, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        folder.load_image_folder(str(image_tree), size=16)
