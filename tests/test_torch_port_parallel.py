"""The port's data parallelism over ``torch.distributed`` (gloo, CPU).

One module-scoped fixture per world size P in {1, 2, 4} spawns P processes
of ``tests/torch_parallel_child.py``; they run every case on their slices of
the inputs and write what they computed, and the tests below compare it,
each as its own parametrised case:

- cross-replica BN (``models/norm.SyncBatchNorm``) against
  ``nn.BatchNorm2d`` on the whole batch: output, input and parameter
  gradients, running buffers;
- ``gather_features``: the view-major layout and the own-rows gradient;
- ``fused_sharded_supcon_loss`` (the kernels' plain forms) against the
  dense loss on the global batch at the loss pins (loss rtol 1e-5, gradient
  atol 1e-5 x its max), SimCLR and SupCon; at P = 1 bitwise equal to
  ``fused_supcon_loss``;
- the P-process train step with ``--syncBN`` against the one-process step
  on the global batch and against the JAX package's one-device step, at
  the JAX package's pins (loss rtol 2e-5; parameters and buffers rtol 1e-3
  / atol 2e-5, ``tests/test_distributed.py:69-77``); without ``--syncBN``
  against the JAX model with ``bn_local_groups=P`` (rank 0's buffers
  against group 0's); at P = 1 bitwise equal to the one-device step;
- the driver (``train.supcon.main``) under P processes against its
  one-process run, rank-0 writes, a signal on one rank stopping all of them
  at one step (exit 75) and their resume from rank 0's save bitwise equal
  to the run that did not stop, a non-finite loss exiting 1 on every rank
  (the last three at P = 2);
- ``preempt.requested_global`` with one rank flagged;
- in this process: ``EpochLoader``'s process slices against the JAX
  package's, the global view draw of ``two_crop_batch``, and the conv and
  loss ladders at world size > 1.

The processes meet through ``file://`` in a fresh directory (no port to
collide under pytest-xdist); every collective has a timeout, and the parent
kills every child when one fails or overruns its wall limit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.data.pipeline import EpochLoader as JaxEpochLoader
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader
from simclr_pytorch_distributed_tpu_torch.ops.augment import AugmentConfig, two_crop_batch
from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()

WORLDS = (1, 2, 4)
WALL_LIMIT = 300  # seconds for one world's processes, spawn to exit
LOSS_RTOL, GRAD_SCALED_ATOL = 1e-5, 1e-5  # the loss kernels' pins (PERF.md §2)
STEP_LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-3, 2e-5  # tests/test_distributed.py
BN_RTOL, BN_ATOL = 1e-5, 1e-5
DRIVER_REL_L2 = 5e-2  # chip_smoke.py's STEP_UPDATE_REL_L2


def _spawn(world, outdir):
    """Run ``world`` child processes to the end and return their results,
    rank by rank; a failed or overrunning child kills its peers."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = child.REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, child.__file__, str(r), str(world), str(outdir)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=WALL_LIMIT)
            assert proc.returncode == 0, f"rank {r} of {world} exited {proc.returncode}:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``results(P)``: the P processes' results, spawned once per module."""
    spawned = {}

    def get(world):
        if world not in spawned:
            spawned[world] = _spawn(world, tmp_path_factory.mktemp(f"world{world}"))
        return spawned[world]

    return get


def assemble(parts, world):
    """Per-rank view-major rows -> the global view-major rows."""
    b = parts[0].shape[0] // 2
    return torch.cat([p[v * b:(v + 1) * b] for v in range(2) for p in parts[:world]])


# -- cross-replica BN --------------------------------------------------------

def bn_reference():
    x, dy, weight, bias, ra_mean, ra_var = child.bn_inputs()
    bn = nn.BatchNorm2d(child.BN_SHAPE[1]).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(ra_mean)
        bn.running_var.copy_(ra_var)
    xr = x.clone().requires_grad_()
    y = bn(xr)
    y.backward(dy)
    return {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "num_batches_tracked": bn.num_batches_tracked}


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", ("y", "dx", "dweight", "dbias", "running_mean", "running_var",
                                  "num_batches_tracked"))
def test_sync_bn_matches_batchnorm_on_the_whole_batch(results, world, name):
    ranks = results(world)
    ref = bn_reference()[name]
    got = [r["sync_bn"][name] for r in ranks]
    if name in ("y", "dx"):  # each rank's rows, in rank order
        got = torch.cat(got)
    elif name in ("dweight", "dbias"):  # each rank's share; the gradient mean adds them
        got = torch.stack(got).sum(0)
    else:  # the same buffers on every rank
        for other in got[1:]:
            assert torch.equal(other, got[0])
        got = got[0]
    torch.testing.assert_close(got, ref, rtol=BN_RTOL, atol=BN_ATOL)


# -- the feature gather -------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_gather_features_is_view_major(results, world):
    rows, _ = child.gather_inputs()
    for r in results(world):
        assert torch.equal(r["gather"]["out"], rows)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_features_gradient_is_own_rows(results, world):
    _, cot = child.gather_inputs()
    assert torch.equal(assemble([r["gather"]["grad"] for r in results(world)], world), cot)


# -- the sharded fused loss ---------------------------------------------------

def dense_loss(method):
    f, labels = child.loss_inputs()
    leaf = f.clone().requires_grad_()
    loss = supcon_loss(leaf, labels if method == "SupCon" else None,
                       temperature=child.TEMP, base_temperature=child.BASE_TEMP)
    loss.backward()
    return loss.detach(), leaf.grad


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", ("SimCLR", "SupCon"))
def test_sharded_loss_matches_dense(results, world, method):
    ref_loss, ref_grad = dense_loss(method)
    ranks = results(world)
    for r in ranks:
        torch.testing.assert_close(r["loss"][method]["loss"], ref_loss, rtol=LOSS_RTOL, atol=0)
    grad = torch.cat([r["loss"][method]["grad"] for r in ranks])
    scale = ref_grad.abs().max().item()
    assert (grad - ref_grad).abs().max().item() <= GRAD_SCALED_ATOL * scale


@pytest.mark.parametrize("method", ("SimCLR", "SupCon"))
def test_sharded_loss_at_one_process_is_fused_loss_bitwise(results, method):
    r = results(1)[0]["loss"][method]
    assert torch.equal(r["loss"], r["unsharded_loss"])
    assert torch.equal(r["grad"], r["unsharded_grad"])


# -- the train step -----------------------------------------------------------

def jax_steps(groups, method):
    """The JAX package's one-device step over the global batches from the
    step cases' init: ``(losses, final torch-layout state dict)``. Groups
    > 1: per-device BN (``bn_local_groups``, ``sync_bn=False``)."""
    views, labels = child.step_inputs()
    variables = state_dict_to_variables(child.init_model().state_dict())
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=child.FEAT,
                             sync_bn=groups == 1, bn_local_groups=groups,
                             bn_group_views=2)
    schedule = jax_make_lr_schedule(**child.SCHED)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), record_norm_mean=jnp.zeros((), jnp.float32),
    )
    step = jax.jit(jax_step.make_train_step(
        jmodel, tx, schedule,
        jax_step.SupConStepConfig(method=method, loss_impl="dense", **child.STEP_KW),
    ))
    losses = []
    for i in range(child.STEPS):
        jstate, m = step(jstate, jnp.asarray(views[i].numpy()), jnp.asarray(labels.numpy()))
        losses.append(float(m["loss"]))
    final = variables_to_state_dict({"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    return losses, final


@pytest.fixture(scope="module")
def jax_reference():
    """``jax_reference(groups, method)``: :func:`jax_steps`, run once per
    module for each pair."""
    done = {}

    def get(groups, method):
        if (groups, method) not in done:
            done[(groups, method)] = jax_steps(groups, method)
        return done[(groups, method)]

    return get


def assert_same_step(got, want_losses, want_state):
    np.testing.assert_allclose([h["loss"] for h in got["history"]], want_losses,
                               rtol=STEP_LOSS_RTOL)
    for key, ref in want_state.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][key].numpy(), ref.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


SYNC_CASES = [name for name, (sync, _, _) in child.STEP_CASES.items() if sync]


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_step_matches_one_process(results, world, case):
    single = results(1)[0]["step_single"][case]
    assert_same_step(results(world)[0]["step"][case], [h["loss"] for h in single["history"]],
                     single["state"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(child.STEP_CASES))
def test_step_matches_jax(results, jax_reference, world, case):
    sync, _, method = child.STEP_CASES[case]
    losses, final = jax_reference(1 if sync else world, method)
    assert_same_step(results(world)[0]["step"][case], losses, final)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", list(child.STEP_CASES))
def test_step_leaves_every_rank_the_same(results, world, case):
    ranks = results(world)
    assert all(r["step"][case]["same_on_every_rank"] for r in ranks)
    for r in ranks[1:]:
        assert r["step"][case]["history"] == ranks[0]["step"][case]["history"]


@pytest.mark.parametrize("case", list(child.STEP_CASES))
def test_step_at_one_process_is_bitwise_the_one_device_step(results, case):
    r = results(1)[0]
    dist_run, single = r["step"][case], r["step_single"][case]
    assert dist_run["history"] == single["history"]
    for key, value in single["state"].items():
        assert torch.equal(dist_run["state"][key], value), key


# -- the driver ---------------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_driver_matches_one_process(results, world):
    """Four steps of the driver at lr 0.5: every step's loss at the step pin;
    the final tensors in relative L2 at ``DRIVER_REL_L2``. Over four steps
    the run is ill-conditioned: two one-process runs that differ only in
    their thread count (1 or 4) end up to 1.8e-2 apart in relative L2 (BN
    biases), beyond the elementwise pins."""
    single = results(1)[0]["driver_single"]
    ranks = results(world)
    assert [r["driver"]["code"] for r in ranks] == [0] * world
    assert {r["driver"]["step"] for r in ranks} == {single["step"]} == {4}
    np.testing.assert_allclose(ranks[0]["driver"]["losses"], single["losses"],
                               rtol=STEP_LOSS_RTOL)
    for key, ref in single["state"].items():
        if ref.is_floating_point():
            got = ranks[0]["driver"]["state"][key]
            assert ((got - ref).norm() / ref.norm()).item() <= DRIVER_REL_L2, key


def test_driver_at_one_process_is_bitwise_the_one_device_run(results):
    r = results(1)[0]
    assert r["driver"]["losses"] == r["driver_single"]["losses"]
    for key, value in r["driver_single"]["state"].items():
        assert torch.equal(r["driver"]["state"][key], value), key


@pytest.mark.parametrize("world", (2, 4))
def test_driver_writes_on_rank_zero_only(results, world):
    ranks = results(world)
    assert len({r["driver"]["save_folder"] for r in ranks}) == 1
    assert ranks[0]["writes"] == ["last.pth"] + (
        ["preempt_epoch_1_step_2.pth", "last.pth", "crash_epoch_1.pth"] if world == 2 else [])
    assert all(r["writes"] == [] for r in ranks[1:])
    folder = ranks[0]["driver"]["save_folder"]
    # besides rank 0's files, each process's flight-recorder files
    # (utils/tracing.run_paths), one pair a process
    recorder = ["events.jsonl", "trace.json"] + [
        name for r in range(1, world) for name in (f"events_p{r}.jsonl", f"trace_p{r}.json")]
    assert sorted(os.listdir(folder)) == sorted(["last.pth", "log-ing"] + recorder)


# the exit paths run at P = 2 only, to keep the file's CPU time small
def test_signal_on_one_rank_stops_every_rank(results):
    assert [r["preempt_code"] for r in results(2)] == [75, 75]


def test_preempted_and_resumed_run_is_bitwise_the_straight_run(results):
    """Rank 0's preemption save (model, SGD, step, the augmentation
    generator) resumes every rank, at the step the signal stopped them."""
    for r in results(2):
        straight, resumed = r["driver"], r["resumed"]
        assert resumed["code"] == 0 and resumed["step"] == straight["step"] == 4
        assert resumed["losses"] == straight["losses"]
        for key, value in straight["state"].items():
            assert torch.equal(resumed["state"][key], value), key


def test_nonfinite_loss_exits_1_on_every_rank(results):
    assert [r["nonfinite_code"] for r in results(2)] == [1, 1]


@pytest.mark.parametrize("world", WORLDS)
def test_requested_global_with_one_rank_flagged(results, world):
    for r in results(world):
        assert r["flags"] == {"none": False, "last_rank": True}


# -- in this process ----------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_epoch_loader_slices_match_jax(world):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (53, 4, 4, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 53).astype(np.int32)
    for index in range(world):
        ours = EpochLoader(images, labels, 8, base_seed=7, process_index=index,
                           process_count=world)
        theirs = JaxEpochLoader(images, labels, 8, base_seed=7, process_index=index,
                                process_count=world)
        assert len(ours) == len(theirs) == 6
        for epoch, start in ((1, 0), (2, 3)):
            for (a, la), (b, lb) in zip(ours.epoch(epoch, start), theirs.epoch(epoch, start),
                                        strict=True):
                assert a.shape[0] == 8 // world
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(la, lb)


def test_epoch_loader_rejects_an_uneven_split():
    images = np.zeros((20, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        EpochLoader(images, np.zeros(20, np.int32), 8, process_count=3)


@pytest.mark.parametrize("world", (2, 4))
def test_two_crop_batch_draws_the_global_batch(world):
    cfg = AugmentConfig(size=8)
    images = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (8, 12, 12, 3)).astype(np.uint8))
    whole_gen = torch.Generator().manual_seed(9)
    whole = two_crop_batch(whole_gen, images, cfg)
    b = 8 // world
    for index in range(world):
        gen = torch.Generator().manual_seed(9)
        part = two_crop_batch(gen, images[index * b:(index + 1) * b], cfg,
                              process_index=index, process_count=world)
        torch.testing.assert_close(part, whole[index * b:(index + 1) * b], rtol=1e-6, atol=1e-6)
        assert torch.equal(gen.get_state(), whole_gen.get_state())


def test_fused_conv_raises_on_more_than_one_process():
    with pytest.raises(ValueError, match="needs a single process, got a world of 2"):
        supcon.resolve_conv_impl("fused", "resnet18", 16, 8, torch.device("cuda"),
                                 world_size=2)


@pytest.mark.parametrize("device", ("cuda", "cpu"))
def test_auto_conv_resolves_to_eager_on_more_than_one_process(device):
    impl, reason = supcon.resolve_conv_impl("auto", "resnet18", 16, 8, torch.device(device),
                                            world_size=4)
    assert impl == "eager"
    assert reason.startswith("data parallel over 4 processes")


def test_loss_ladder_names_the_sharded_form():
    impl, reason = supcon.resolve_loss_impl_reasoned("auto", torch.device("cuda"), 2)
    assert impl == "fused" and "sharded over 2 process(es)" in reason
    impl, reason = supcon.resolve_loss_impl_reasoned("auto", torch.device("cuda"))
    assert impl == "fused" and "sharded" not in reason
