"""The port's schedule, optimizer, train step and loader against the JAX
package's.

- ``make_lr_schedule`` at every step of a short run, cosine and step decay,
  with warm-up (rtol 1e-5).
- Three ``train_step`` calls from one rn10 init on fixed pre-augmented
  views against the JAX package's ``make_train_step`` with the same loss
  path: the loss at every step (rtol 1e-4), ``record_norm_mean``, and every
  parameter and BN buffer after the third step (rtol 1e-3 / atol 1e-5),
  with the SEC and l2reg terms on and an EMA momentum below 1.
- ``EpochLoader`` batches byte-identical to the JAX package's, with and
  without ``start_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simclr_pytorch_distributed_tpu.data.pipeline import EpochLoader as JaxEpochLoader
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (
    SupConStepConfig,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("warm", [True, False])
def test_lr_schedule_matches_jax(cosine, warm):
    kwargs = dict(
        learning_rate=0.5, epochs=16, steps_per_epoch=3, cosine=cosine,
        lr_decay_rate=0.1, lr_decay_epochs=(11, 14), warm=warm, warm_epochs=10,
        warmup_from=0.01,
    )
    ours = make_lr_schedule(**kwargs)
    theirs = jax_make_lr_schedule(**kwargs)
    for step in range(16 * 3):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5,
                                   err_msg=f"step {step}")


B, SIZE, STEPS = 8, 8, 3


def _init_port_model():
    torch.manual_seed(5)
    model = SupConResNet("resnet10", "mlp", 32)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return model


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
def test_three_steps_match_jax(loss_impl):
    rng = np.random.default_rng(11)
    views = [rng.standard_normal((B, 2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(STEPS)]
    labels = rng.integers(0, 3, B).astype(np.int32)
    sched_kwargs = dict(learning_rate=0.1, epochs=1, steps_per_epoch=STEPS, cosine=True)
    step_kwargs = dict(
        method="SimCLR", temperature=0.5, sec=True, sec_wei=0.5, l2reg=True,
        l2reg_wei=0.05, norm_momentum=0.6, epochs=1, steps_per_epoch=STEPS,
        grad_div=2.0, loss_impl=loss_impl,
    )

    model = _init_port_model()
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**sched_kwargs))
    cfg = SupConStepConfig(**step_kwargs)

    variables = state_dict_to_variables(model.state_dict())
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=32)
    schedule = jax_make_lr_schedule(**sched_kwargs)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
    )
    jstep = jax.jit(jax_step.make_train_step(
        jmodel, tx, schedule, jax_step.SupConStepConfig(**step_kwargs)
    ))

    for i in range(STEPS):
        m = train_step(state, cfg, torch.from_numpy(views[i]), torch.from_numpy(labels))
        jstate, jm = jstep(jstate, jnp.asarray(views[i]), jnp.asarray(labels))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {i}")
        for key in ("record_norm_mean", "norm_mean", "loss_sec", "loss_l2reg"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                       err_msg=f"{key}, step {i}")
        np.testing.assert_allclose(m["learning_rate"].item(), float(jm["learning_rate"]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == STEPS

    final = variables_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ours = model.state_dict()
    for key, ref in final.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(ours[key].numpy(), ref.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_epoch_loader_batches_match_jax():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (53, 4, 4, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 53).astype(np.int32)
    ours = EpochLoader(images, labels, 8, base_seed=7)
    theirs = JaxEpochLoader(images, labels, 8, base_seed=7)
    assert len(ours) == len(theirs) == 6
    for epoch, start in ((1, 0), (2, 0), (2, 3), (3, 5)):
        got = list(ours.epoch(epoch, start_step=start))
        ref = list(theirs.epoch(epoch, start_step=start))
        assert len(got) == len(ref) == 6 - start
        for (gi, gl), (ri, rl) in zip(got, ref):
            assert gi.dtype == ri.dtype and gl.dtype == rl.dtype
            assert gi.tobytes() == ri.tobytes() and gl.tobytes() == rl.tobytes()
    with pytest.raises(ValueError, match="start_step"):
        list(ours.epoch(1, start_step=6))


def test_epoch_loader_abandoned_epoch_stops_its_worker():
    images = np.zeros((40, 2, 2, 3), np.uint8)
    loader = EpochLoader(images, np.zeros(40, np.int32), 4, prefetch=1)
    it = loader.epoch(1)
    next(it)
    it.close()  # the prefetch worker must not stay blocked in put()
    import threading
    assert not any(t.name == "EpochLoader-prefetch" for t in threading.enumerate())
