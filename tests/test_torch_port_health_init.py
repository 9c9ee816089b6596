"""The collapse detector's bar at a ResNet-50 init: the port against the
JAX package, on one bridged init, on the CPU.

On the card the detector fires on the port's ResNet-50 fp32 run from its
first steps: the embedding's effective rank reads 1.76-1.77 against the
bar ``eff_rank_min = 2.0``. The JAX detector assumes a random-init encoder
spreads its projections to ``eff_rank >> 2`` (its ``utils/guard.py``). So
the question is whether the JAX package's own init reads below the bar
too, or whether the port's init or forward differs.

The port's seeded ``SupConResNet('resnet50')`` (a true init: BN scale 1,
shift 0) moves to the JAX model through ``utils/convert.py``; both run one
two-view batch in train mode, 32 pairs of 32-px images (64 rows, view-major:
rows ``i`` and ``i + 32`` are the two views of image ``i``; the second view
is the first flipped left-right with seeded noise), and read
``health_eff_rank``, ``health_align`` and ``health_neg_mean`` of their
unit-normalized projections (``train/supcon_step.contrastive_health_metrics``
on both sides; the port's effective rank on the host from the covariance).

Tolerance: rtol 1e-3 on the three readings. BN in train mode, fp32: the
batch statistics at layer4's 4x4 px run over 1024 values a channel, and the
two sides sum 50 layers in different orders, so the projections agree to
about 1e-4 relative; the readings are means over the 64 x 64 similarities
and the spectrum of the 128 x 128 covariance, which average that error
down. Both sides must read on the same side of the bar, which this test
keeps at 2.0 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.train import supcon_step as jstep
from simclr_pytorch_distributed_tpu.utils import guard as jguard
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    HEALTH_COV,
    contrastive_health_metrics,
    effective_rank,
)
from simclr_pytorch_distributed_tpu_torch.utils import guard
from simclr_pytorch_distributed_tpu_torch.utils.convert import state_dict_to_variables
from torch_threads import limit_threads

limit_threads()

PAIRS, SIZE, SEED = 32, 32, 0
RTOL = 1e-3
KEYS = ("health_eff_rank", "health_align", "health_neg_mean")
MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)  # CIFAR-10's normalization
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def two_view_batch():
    """``[2B, 32, 32, 3]`` NHWC, view-major, normalized as the loader does."""
    rng = np.random.default_rng(SEED)
    images = rng.uniform(0.0, 1.0, (PAIRS, SIZE, SIZE, 3)).astype(np.float32)
    second = np.clip(images[:, :, ::-1] + rng.normal(0.0, 0.05, images.shape), 0.0, 1.0)
    views = np.concatenate([images, second.astype(np.float32)])
    return (views - MEAN) / STD


def unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def readings():
    torch.manual_seed(SEED)
    port = SupConResNet("resnet50")
    variables = state_dict_to_variables(port.state_dict())
    x = two_view_batch()
    port.train()
    with torch.no_grad():
        proj_p = port(torch.from_numpy(x)).numpy()
    proj_j, _ = JaxSupConResNet(model_name="resnet50").apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    emb_p, emb_j = unit(proj_p.astype(np.float64)).astype(np.float32), unit(np.asarray(proj_j))
    m = contrastive_health_metrics(torch.from_numpy(emb_p), torch.zeros(()))
    ours = {k: float(m[k]) for k in KEYS if k != "health_eff_rank"}
    ours["health_eff_rank"] = effective_rank(m[HEALTH_COV].numpy())
    theirs = {k: float(v) for k, v in jstep.contrastive_health_metrics(
        jnp.asarray(emb_j), {"w": jnp.zeros(1)}).items() if k in KEYS}
    return ours, theirs, proj_p, np.asarray(proj_j)


def test_the_bridged_init_projects_the_same(readings):
    _, _, proj_p, proj_j = readings
    np.testing.assert_allclose(proj_p, proj_j, rtol=RTOL, atol=RTOL * np.abs(proj_j).max())


@pytest.mark.parametrize("key", KEYS)
def test_the_health_readings_agree_with_jax(readings, key):
    ours, theirs, _, _ = readings
    np.testing.assert_allclose(ours[key], theirs[key], rtol=RTOL)


def test_both_packages_read_the_same_side_of_the_bar(readings):
    ours, theirs, _, _ = readings
    bar = guard.HealthThresholds().eff_rank_min
    assert (ours["health_eff_rank"] < bar) == (theirs["health_eff_rank"] < bar)
    # the finding: a ResNet-50 init reads below the bar on both sides, so
    # the detector's alarm in a run's first steps is the bar's, not the port's
    assert theirs["health_eff_rank"] < bar


def test_the_bar_is_two_in_both_packages():
    assert guard.HealthThresholds().eff_rank_min == jguard.HealthThresholds().eff_rank_min == 2.0
