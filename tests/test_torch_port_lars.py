"""The port's LARS (``--optimizer lars``) against the JAX package's
``make_optimizer(..., optimizer="lars")`` (``optax.lars`` with weight decay
and the trust ratio masked to kernels).

- Three updates of a small parameter tree (conv and linear kernels, 1-D
  biases and BN scales, a zero kernel whose trust ratio falls back to 1)
  on fixed gradients, with the learning rate from a warm-up cosine
  schedule at each step: every parameter after every update within rtol
  1e-6 (atol 1e-9 for entries that cancel).
- Three rn10 ``train_step`` calls at 16 px with ``--optimizer lars``
  against the jitted JAX step, at ``tests/test_torch_port_step.py``'s pins
  (loss rtol 1e-4; parameters and BN buffers rtol 1e-3 / atol 1e-5).
- The optimizer's state (``momentum_buffer`` per parameter) survives a
  checkpoint and ``--resume`` bitwise: the driver for one epoch then
  ``--resume`` ends equal to the two-epoch run, losses and tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.state import (
    LARS,
    TrainState,
    make_optimizer,
)
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

SHAPES = {"conv": (8, 3, 3, 3), "fc": (10, 16), "bias": (10,), "bn_scale": (8,),
          "zero_kernel": (4, 4)}
SCHED = dict(learning_rate=0.5, epochs=2, steps_per_epoch=3, cosine=True, warm=True,
             warm_epochs=1, warmup_from=0.01, lr_decay_rate=0.1, lr_decay_epochs=(1,))


def tree(seed):
    """Parameters and three steps of gradients, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero_kernel"][:] = 0.0
    grads = [{k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("momentum", (0.9, 0.0))
@pytest.mark.parametrize("weight_decay", (1e-4, 1e-2, 0.0))
@pytest.mark.parametrize("seed", (0, 1))
def test_lars_updates_match_optax(momentum, weight_decay, seed):
    params, grads = tree(seed)
    ours = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = LARS(list(ours.values()), momentum=momentum, weight_decay=weight_decay)
    sched = make_lr_schedule(**SCHED)
    tx = jax_state.make_optimizer(jax_make_lr_schedule(**SCHED), momentum=momentum,
                                  weight_decay=weight_decay, optimizer="lars")
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(theirs)
    for step, g in enumerate(grads):
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = float(sched(step))
        opt.step()
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       theirs)
        theirs = jax.tree.map(lambda p, u: p + u, theirs, updates)
        for k in SHAPES:
            np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(theirs[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{k}, step {step}")


def test_lars_trust_ratio_is_kernels_only():
    """A 1-D parameter takes plain momentum SGD without weight decay."""
    p = nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = LARS([p], momentum=0.9, weight_decay=0.5)
    opt.param_groups[0]["lr"] = 0.1
    p.grad = torch.tensor([0.5, 0.5])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([0.95, -2.05]), rtol=0, atol=1e-7)


def test_make_optimizer_choices():
    model = nn.Linear(3, 2)
    assert isinstance(make_optimizer(model), torch.optim.SGD)
    assert isinstance(make_optimizer(model, optimizer="lars"), LARS)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(model, optimizer="adam")


def test_three_lars_steps_match_jax():
    """``tests/test_torch_port_step.py``'s three-step case with LARS."""
    b, size, steps = 8, 16, 3
    rng = np.random.default_rng(11)
    views = [rng.standard_normal((b, 2, size, size, 3)).astype(np.float32) for _ in range(steps)]
    labels = rng.integers(0, 3, b).astype(np.int32)
    sched_kwargs = dict(learning_rate=0.5, epochs=1, steps_per_epoch=steps, cosine=True)
    step_kwargs = dict(method="SimCLR", temperature=0.5, sec=True, sec_wei=0.5, l2reg=True,
                       l2reg_wei=0.05, norm_momentum=0.6, epochs=1, steps_per_epoch=steps,
                       grad_div=2.0, loss_impl="dense")
    model = child.init_model()
    state = TrainState(model, make_optimizer(model, optimizer="lars"),
                       make_lr_schedule(**sched_kwargs))
    cfg = SupConStepConfig(**step_kwargs)

    variables = state_dict_to_variables(model.state_dict())
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=child.FEAT)
    schedule = jax_make_lr_schedule(**sched_kwargs)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4, optimizer="lars")
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
    )
    jstep = jax.jit(jax_step.make_train_step(
        jmodel, tx, schedule, jax_step.SupConStepConfig(**step_kwargs)))
    for i in range(steps):
        m = train_step(state, cfg, torch.from_numpy(views[i]), torch.from_numpy(labels))
        jstate, jm = jstep(jstate, jnp.asarray(views[i]), jnp.asarray(labels))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(m["learning_rate"].item(), float(jm["learning_rate"]),
                                   rtol=1e-5)
    final = variables_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ours = model.state_dict()
    for key, ref in final.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(ours[key].numpy(), ref.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_lars_state_survives_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(supcon, "load_dataset", child.tiny_dataset)
    base = child.DRIVER_ARGV + ["--optimizer", "lars", "--loss_impl", "dense"]
    with torch.random.fork_rng():
        _, straight = child.driver_run(str(tmp_path / "straight"), "--epochs", "2", base=base)
        _, first = child.driver_run(str(tmp_path / "first"), "--epochs", "1", base=base)
        _, resumed = child.driver_run(str(tmp_path / "resumed"), "--epochs", "2", "--resume",
                                      first.save_folder, base=base)
    assert isinstance(resumed.state.optimizer, LARS)
    assert [h["loss"] for h in first.history + resumed.history] == [
        h["loss"] for h in straight.history]
    want, got = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert len(want["state"]) == len(list(straight.state.model.parameters()))
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k]["momentum_buffer"], v["momentum_buffer"]), k
    for key, value in straight.state.model.state_dict().items():
        assert torch.equal(resumed.state.model.state_dict()[key], value), key
    with open(f"{straight.save_folder}/log-ing") as fh:
        assert "[optimizer] 'lars'" in fh.read()
