"""SimCLR two-crop augmentation, batched on the device.

Semantics of ``simclr_pytorch_distributed_tpu/ops/augment.py`` and the
recipe's torchvision stack (reference ``main_supcon.py:170-179``):

- ``RandomResizedCrop(size, scale=(0.2, 1.0))`` with torchvision's
  10-attempt area/aspect sampling, first valid attempt wins, else the
  aspect-clamped center crop;
- ``RandomHorizontalFlip`` (p=0.5);
- ``ColorJitter(0.4, 0.4, 0.4, 0.1)`` applied with p=0.8, uniform factors
  and a random permutation of the four ops' order;
- ``RandomGrayscale(p=0.2)`` (ITU-R 601 luma);
- normalize with per-dataset mean/std.

The random draws are split from their application: :func:`sample_view_params`
draws every view's parameters on the device from a ``torch.Generator``, and
:func:`apply_views` is a deterministic function of images and parameters.
The generators of JAX and torch give different numbers from one seed, so the
tests hand both packages the same explicit parameters and check the
samplers by distribution.

The probe's stack (``color_ops=False``, reference ``main_ce.py:31-41``) is
the crop and the flip alone, one view per image (:func:`augment_batch`);
its validation transform is to-float and normalize only
(:func:`eval_batch`).

Images are NHWC; ops take and return floats in [0, 1] until normalization.
The crop+resize is two interpolation matmuls (half-pixel centers, samples
clamped to the crop box), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import torch

# Per-dataset normalization constants (main_supcon.py:157-162).
DATASET_STATS = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)),
}

_LUMA = (0.299, 0.587, 0.114)
_RATIO = (3.0 / 4.0, 4.0 / 3.0)  # RandomResizedCrop's aspect range
_ATTEMPTS = 10  # RandomResizedCrop's tries before the center-crop fallback


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The contrastive-pretrain transform stack (main_supcon.py:170-179)."""

    size: int = 32
    scale: Tuple[float, float] = (0.2, 1.0)
    jitter_prob: float = 0.8
    jitter_strength: Tuple[float, float, float, float] = (0.4, 0.4, 0.4, 0.1)
    grayscale_prob: float = 0.2
    mean: Tuple[float, ...] = DATASET_STATS["cifar10"][0]
    std: Tuple[float, ...] = DATASET_STATS["cifar10"][1]
    # the probe's stack drops jitter and grayscale (main_ce.py:31-36)
    color_ops: bool = True


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def sample_view_params(
    generator: torch.Generator, n: int, height: int, width: int, cfg: AugmentConfig
) -> Dict[str, torch.Tensor]:
    """Draw the random parameters of ``n`` views of ``height x width``
    images, on the generator's device.

    Returns ``top, left, h, w`` (crop box, float ``[n]``), ``flip``,
    ``jitter``, ``gray`` (bool ``[n]``), ``factors`` (``[n, 4]``:
    brightness, contrast, saturation, hue) and ``order`` (``[n, 4]``, a
    permutation of the op indices 0..3 per view). Without
    ``cfg.color_ops`` only the crop box and ``flip`` are drawn.
    """
    dev = generator.device
    area = float(height * width)
    k = _ATTEMPTS
    target_area = area * _uniform(generator, (n, k), cfg.scale[0], cfg.scale[1], dev)
    log_ratio = _uniform(
        generator, (n, k), math.log(_RATIO[0]), math.log(_RATIO[1]), dev
    )
    aspect = torch.exp(log_ratio)
    ws = torch.round(torch.sqrt(target_area * aspect))
    hs = torch.round(torch.sqrt(target_area / aspect))
    valid = (ws > 0) & (ws <= width) & (hs > 0) & (hs <= height)
    first = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)  # first valid
    any_valid = valid.any(dim=1)
    w = torch.gather(ws, 1, first)[:, 0]
    h = torch.gather(hs, 1, first)[:, 0]
    # torchvision's fallback: clamp the aspect to the ratio range, center crop
    in_ratio = width / height
    if in_ratio < _RATIO[0]:
        fb_w, fb_h = float(width), float(round(width / _RATIO[0]))
    elif in_ratio > _RATIO[1]:
        fb_w, fb_h = float(round(height * _RATIO[1])), float(height)
    else:
        fb_w, fb_h = float(width), float(height)
    w = torch.where(any_valid, w, torch.full_like(w, fb_w))
    h = torch.where(any_valid, h, torch.full_like(h, fb_h))
    u = torch.rand((n, 2), generator=generator, device=dev)
    top = torch.where(
        any_valid, torch.floor(u[:, 0] * (height - h + 1)), torch.round((height - h) / 2.0)
    )
    left = torch.where(
        any_valid, torch.floor(u[:, 1] * (width - w + 1)), torch.round((width - w) / 2.0)
    )
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    if not cfg.color_ops:
        return {"top": top, "left": left, "h": h, "w": w, "flip": flip}
    jitter = torch.rand(n, generator=generator, device=dev) < cfg.jitter_prob
    b, c, s, hue = cfg.jitter_strength
    factors = torch.stack(
        [
            _uniform(generator, (n,), 1 - b, 1 + b, dev),
            _uniform(generator, (n,), 1 - c, 1 + c, dev),
            _uniform(generator, (n,), 1 - s, 1 + s, dev),
            _uniform(generator, (n,), -hue, hue, dev),
        ],
        dim=1,
    )
    order = torch.argsort(torch.rand((n, 4), generator=generator, device=dev), dim=1)
    gray = torch.rand(n, generator=generator, device=dev) < cfg.grayscale_prob
    return {
        "top": top, "left": left, "h": h, "w": w, "flip": flip,
        "jitter": jitter, "factors": factors, "order": order, "gray": gray,
    }


def _interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """Bilinear interpolation matrices ``M[v, out, n]`` (out = M @ src),
    edge-clamped: at the border both taps coincide and sum to 1."""
    c = coords.clamp(0.0, n - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    c0i = c0.to(torch.int64).clamp(0, n - 1)
    c1i = (c0i + 1).clamp(0, n - 1)
    grid = torch.arange(n, device=coords.device)
    return (grid == c0i[..., None]) * (1.0 - frac)[..., None] + (
        grid == c1i[..., None]
    ) * frac[..., None]


def crop_and_resize(img, top, left, h, w, out_size: int) -> torch.Tensor:
    """Bilinear-resize each view's ``(top, left, h, w)`` crop of ``img``
    ``[n, H, W, C]`` to ``[n, out_size, out_size, C]``."""
    H, W = img.shape[1], img.shape[2]
    d = torch.arange(out_size, dtype=torch.float32, device=img.device)
    ys = top[:, None] + (d + 0.5) * (h[:, None] / out_size) - 0.5
    xs = left[:, None] + (d + 0.5) * (w[:, None] / out_size) - 0.5
    # clamp to the crop box, not the image: torchvision resizes a cropped image
    ys = torch.minimum(torch.maximum(ys, top[:, None]), (top + h - 1.0)[:, None])
    xs = torch.minimum(torch.maximum(xs, left[:, None]), (left + w - 1.0)[:, None])
    wy = _interp_matrix(ys, H)  # [n, out, H]
    wx = _interp_matrix(xs, W)  # [n, out, W]
    rows = torch.einsum("nsh,nhwc->nswc", wy, img)
    return torch.einsum("nxw,nswc->nsxc", wx, rows)


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device):
    """A per-channel constant on ``device``, made once: on CUDA through
    pinned memory, so neither the first call nor a later one waits for the
    device (a ``torch.tensor(..., device=cuda)`` is a synchronizing copy)."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    w = _constant(_LUMA, img.dtype, img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def _per_view(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, 1, 1)


def adjust_brightness(img, factor):
    return (img * _per_view(factor)).clamp(0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    f = _per_view(factor)
    return (f * img + (1.0 - f) * mean).clamp(0.0, 1.0)


def adjust_saturation(img, factor):
    f = _per_view(factor)
    return (f * img + (1.0 - f) * _grayscale(img)).clamp(0.0, 1.0)


def adjust_hue(img, delta):
    """Shift hue by ``delta`` (turns, in [-0.5, 0.5]) via an HSV round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, c / maxc.clamp_min(1e-12), zero)
    safe_c = c.clamp_min(1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(
        r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(c == 0, zero, h)
    h = torch.remainder(h + delta.reshape(-1, 1, 1), 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6)
    r2 = torch.stack([v, q, p, p, t, v], dim=-1)
    g2 = torch.stack([t, v, v, q, p, p], dim=-1)
    b2 = torch.stack([p, p, t, v, v, q], dim=-1)
    idx = sector[..., None]
    return torch.cat(
        [torch.gather(x, -1, idx) for x in (r2, g2, b2)], dim=-1
    )


_JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(img, factors, order):
    """The four ops in each view's own ``order``: at position ``k`` every
    view takes the result of the op its permutation names there."""
    for k in range(4):
        out = torch.zeros_like(img)
        for op_idx, op in enumerate(_JITTER_OPS):
            take = _per_view(order[:, k] == op_idx)
            out = torch.where(take, op(img, factors[:, op_idx]), out)
        img = out
    return img


def normalize(img, mean: Sequence[float], std: Sequence[float]):
    m = _constant(tuple(mean), img.dtype, img.device)
    s = _constant(tuple(std), img.dtype, img.device)
    return (img - m) / s


def apply_views(images_u8: torch.Tensor, params: Dict[str, torch.Tensor], cfg: AugmentConfig):
    """Deterministic augmentation: uint8 ``[n, H, W, C]`` images and one
    parameter set per image -> normalized float ``[n, size, size, C]``."""
    img = images_u8.to(torch.float32) / 255.0
    img = crop_and_resize(img, params["top"], params["left"], params["h"], params["w"], cfg.size)
    img = torch.where(_per_view(params["flip"]), img.flip(2), img)
    if cfg.color_ops:
        jittered = color_jitter(img, params["factors"], params["order"])
        img = torch.where(_per_view(params["jitter"]), jittered, img)
        img = torch.where(_per_view(params["gray"]), _grayscale(img).expand_as(img), img)
    return normalize(img, cfg.mean, cfg.std)


def two_crop_batch(generator: torch.Generator, images_u8: torch.Tensor, cfg: AugmentConfig,
                   *, process_index: int = 0, process_count: int = 1):
    """TwoCropTransform over a batch: uint8 ``[B, H, W, C]`` ->
    ``[B, 2, size, size, C]`` float, two independent draws per image.

    Under data parallelism ``images_u8`` is process ``process_index``'s
    slice of a global batch ``process_count`` times its size: the view
    parameters are drawn for the whole global batch, as the one-process
    run draws them, and this process applies its own rows. So P processes
    see the crops one process sees, and every process's generator stays in
    the same state (rank 0's saved state resumes them all)."""
    b, height, width = images_u8.shape[0], images_u8.shape[1], images_u8.shape[2]
    params = sample_view_params(generator, 2 * b * process_count, height, width, cfg)
    if process_count > 1:
        lo = 2 * b * process_index
        params = {k: v[lo:lo + 2 * b] for k, v in params.items()}
    views = apply_views(images_u8.repeat_interleave(2, dim=0), params, cfg)
    return views.reshape((b, 2) + views.shape[1:])


def skip_view_draws(generator: torch.Generator, steps: int, batch_size: int, height: int,
                    width: int, cfg: AugmentConfig) -> None:
    """Advance ``generator`` as ``steps`` calls of :func:`two_crop_batch` on
    a global batch of ``batch_size`` images of ``height x width`` would,
    without applying the views: the NaN rollback's skipped steps."""
    for _ in range(steps):
        sample_view_params(generator, 2 * batch_size, height, width, cfg)


def augment_batch(generator: torch.Generator, images_u8: torch.Tensor, cfg: AugmentConfig,
                  *, process_index: int = 0, process_count: int = 1):
    """One augmented view per image (the probe's train transform): uint8
    ``[B, H, W, C]`` -> ``[B, size, size, C]`` float. Under data
    parallelism the draws are the global batch's and this process applies
    its rows, as in :func:`two_crop_batch`."""
    b, height, width = images_u8.shape[0], images_u8.shape[1], images_u8.shape[2]
    params = sample_view_params(generator, b * process_count, height, width, cfg)
    if process_count > 1:
        params = {k: v[b * process_index:b * (process_index + 1)] for k, v in params.items()}
    return apply_views(images_u8, params, cfg)


def eval_batch(images_u8: torch.Tensor, cfg: AugmentConfig):
    """The validation transform: to-float and normalize only
    (``main_ce.py:38-41``)."""
    return normalize(images_u8.to(torch.float32) / 255.0, cfg.mean, cfg.std)
