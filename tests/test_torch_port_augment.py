"""The port's batched augmentation against the JAX package's functions.

JAX's threefry and torch's Philox give different numbers from one seed, so
the deterministic half is compared on explicit parameters made with numpy:
the port's ``apply_views`` against the JAX package's ``crop_and_resize``,
flip, ``adjust_*`` in the given order, grayscale and normalize, per image
(atol 1e-5). The sampler is checked by distribution and range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.ops import augment as jaug
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    AugmentConfig,
    apply_views,
    sample_view_params,
    two_crop_batch,
)
from torch_threads import limit_threads

limit_threads()

CFG = AugmentConfig(size=12, mean=(0.5, 0.4, 0.3), std=(0.25, 0.2, 0.3))


def _explicit_params(rng, n, height, width):
    h = rng.integers(4, height + 1, n).astype(np.float32)
    w = rng.integers(4, width + 1, n).astype(np.float32)
    top = np.floor(rng.random(n) * (height - h + 1)).astype(np.float32)
    left = np.floor(rng.random(n) * (width - w + 1)).astype(np.float32)
    factors = np.stack([
        rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
        rng.uniform(0.6, 1.4, n), rng.uniform(-0.1, 0.1, n),
    ], axis=1).astype(np.float32)
    return {
        "top": top, "left": left, "h": h, "w": w,
        "flip": rng.random(n) < 0.5,
        "jitter": rng.random(n) < 0.7,
        "gray": rng.random(n) < 0.3,
        "factors": factors,
        "order": np.stack([rng.permutation(4) for _ in range(n)]),
    }


def _jax_view(img_u8, p, i, cfg):
    ops = (jaug.adjust_brightness, jaug.adjust_contrast,
           jaug.adjust_saturation, jaug.adjust_hue)
    img = jaug.to_float(jnp.asarray(img_u8))
    img = jaug.crop_and_resize(img, p["top"][i], p["left"][i], p["h"][i], p["w"][i], cfg.size)
    if p["flip"][i]:
        img = img[:, ::-1, :]
    if p["jitter"][i]:
        for op in p["order"][i]:
            img = ops[op](img, p["factors"][i, op])
    if p["gray"][i]:
        img = jnp.broadcast_to(jaug._grayscale(img), img.shape)
    return np.asarray(jaug.normalize(img, cfg.mean, cfg.std))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_views_matches_jax_on_explicit_params(seed):
    rng = np.random.default_rng(seed)
    n, height, width = 10, 16, 20
    images = rng.integers(0, 256, (n, height, width, 3)).astype(np.uint8)
    p = _explicit_params(rng, n, height, width)
    got = apply_views(
        torch.from_numpy(images), {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, CFG
    ).numpy()
    assert got.shape == (n, CFG.size, CFG.size, 3) and got.dtype == np.float32
    for i in range(n):
        np.testing.assert_allclose(got[i], _jax_view(images[i], p, i, CFG), atol=1e-5,
                                   err_msg=f"view {i}")


def test_sampler_distribution_and_ranges():
    n, height, width = 4000, 32, 32
    gen = torch.Generator().manual_seed(0)
    drawn = sample_view_params(gen, n, height, width, AugmentConfig())
    p = {k: v.numpy() for k, v in drawn.items()}
    h, w = p["h"], p["w"]
    # crop boxes lie inside the image, at whole-pixel positions
    assert np.all(p["top"] >= 0) and np.all(p["top"] + h <= height)
    assert np.all(p["left"] >= 0) and np.all(p["left"] + w <= width)
    for x in (h, w, p["top"], p["left"]):
        np.testing.assert_array_equal(x, np.round(x))
    # area within scale (0.2, 1) and aspect within (3/4, 4/3), up to the
    # rounding of each side to whole pixels (half a pixel each way)
    area = h * w / (height * width)
    assert area.min() >= 0.2 * (1 - 1 / np.sqrt(0.2 * height * width)) ** 2
    assert area.max() <= 1.0
    aspect = w / h
    assert aspect.min() >= (3 / 4) * (1 - 0.5 / 10) / (1 + 0.5 / 10)
    assert aspect.max() <= (4 / 3) * (1 + 0.5 / 10) / (1 - 0.5 / 10)
    assert 0.35 < np.median(area) < 0.75  # not stuck at an end of the range
    # rates: 4000 draws put 4 standard deviations under 0.032
    assert abs(p["flip"].mean() - 0.5) < 0.032
    assert abs(p["jitter"].mean() - 0.8) < 0.032
    assert abs(p["gray"].mean() - 0.2) < 0.032
    f = p["factors"]
    for col, lo, hi in ((0, 0.6, 1.4), (1, 0.6, 1.4), (2, 0.6, 1.4), (3, -0.1, 0.1)):
        assert f[:, col].min() >= lo and f[:, col].max() <= hi
        assert f[:, col].min() < lo + 0.01 and f[:, col].max() > hi - 0.01
    # every row a permutation of the four ops, each op at each position ~1/4
    np.testing.assert_array_equal(np.sort(p["order"], axis=1), np.tile(np.arange(4), (n, 1)))
    for pos in range(4):
        counts = np.bincount(p["order"][:, pos], minlength=4) / n
        assert np.all(np.abs(counts - 0.25) < 0.03)


def test_sampler_falls_back_to_a_center_crop():
    # a 2x40 image admits no crop with aspect in (3/4, 4/3): torchvision's
    # fallback clamps the aspect to 4/3 and centers the crop
    gen = torch.Generator().manual_seed(1)
    p = sample_view_params(gen, 50, 2, 40, AugmentConfig())
    np.testing.assert_array_equal(p["h"].numpy(), 2.0)
    np.testing.assert_array_equal(p["w"].numpy(), 3.0)
    np.testing.assert_array_equal(p["left"].numpy(), round((40 - 3) / 2.0))


def test_two_crop_batch_shape_and_dtype():
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    )
    views = two_crop_batch(torch.Generator().manual_seed(0), images, AugmentConfig(size=16))
    assert views.shape == (5, 2, 16, 16, 3) and views.dtype == torch.float32
    assert torch.isfinite(views).all()
    assert not torch.equal(views[:, 0], views[:, 1])  # two independent draws
