"""One process of the port's data-parallel CPU tests (gloo).

    python tests/torch_parallel_child.py RANK WORLD OUTDIR [SUITE [ARG]]

Joins a gloo process group of WORLD processes through ``file://OUTDIR/store``,
runs every case of one suite on its slice of the inputs, and writes what it
computed to ``OUTDIR/rank{RANK}.pt``; the test compares. The inputs are made
here from numpy seeds, by functions the tests import too. The suites:

- ``parallel`` (the default), for ``tests/test_torch_port_parallel.py``. At
  WORLD = 1 the process also runs each case without a process group (the
  one-process references), after leaving the group.
- ``ring``, for ``tests/test_torch_port_ring.py``: the ring loss, counted
  ring steps, the ring + LARS step, and the probe driver.
- ``resilience``, for ``tests/test_torch_port_rollback.py``: the driver
  straight, SIGTERM'd mid-epoch, resumed from ARG (a run folder saved
  under another world size), and rolled back after a non-finite loss.
- ``telemetry``, for ``tests/test_torch_port_telemetry.py``: the flush
  boundary's failure-code exchange with failures on some ranks, and the
  health and online-probe columns of data-parallel steps (fused and ring
  loss).
- ``ce``, for ``tests/test_torch_port_ce.py``: the CE driver.
- ``placement``, for ``tests/test_torch_port_device_store.py``: the
  placement ladder with a budget that differs between the processes, an
  explicit ``device`` one process cannot meet, and the store ``make_store``
  builds, whose batches each process returns.
- ``recipes``, for ``tests/test_torch_port_recipe_step.py``: steps of the
  byol and vicreg recipes with ``--syncBN``, and byol under the ring loss;
  then the driver with ``--print_freq 3`` and a signal on the last rank
  after step 1, the votes counted, and its resume against the straight
  run.
- ``skew``, for ``tests/test_torch_port_telemetry.py``: boundary exchanges
  with the last rank paced by ``SKEW_PACE_S`` before each, the gauges and
  ``boundary_skew`` events after each, and the collectives counted.
- ``tp``, for ``tests/test_torch_port_tensor_parallel.py``: the grid of
  WORLD processes at ``--model_parallel 2`` (``TP``; at WORLD = 3 one model
  group of 3 with a 96-wide head, ``TP_MIXED``), its groups, the step
  cases of ``TP_STEP_CASES`` on this process's shards (losses, shards,
  momentum, the health gradient norm), one case's collectives counted by
  group (``utils/profiling.count_collectives``); at WORLD = 2 also a data-parallel
  step before and after a grid of ``N = 1`` (bitwise the same), and the
  driver at ``N = 2`` and ``N = 1`` with a resume from each into the other;
  then the recipe cases of ``TP_RECIPE_CASES`` (at WORLD = 3 byol alone)
  from converted weights and slots, and at WORLD = 2 the recipe driver
  (byol and the queue at ``N = 2``, resumed at ``N = 1`` and back).
- ``fleet``, for ``scripts/port_fleet_launcher.py``: the driver at ``--size 8
  --print_freq 1`` with ARG a JSON object (``workdir``, ``epochs``, ``resume``), the
  sidecar on ``CHILD_METRICS_PORT`` where that is set, and the rank
  ``FLEET_STRAGGLER_PID`` late by ``FLEET_STRAGGLER_MS`` at every boundary
  where that is set. It prints ``DRIVER step=<n> digest=<sha256 of the
  model state> save_folder=<path>`` and exits with the driver's code (75
  when preempted), writing no result file.
"""

import contextlib
import datetime
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from simclr_pytorch_distributed_tpu_torch import config as config_lib  # noqa: E402
from simclr_pytorch_distributed_tpu_torch import recipes  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.data import device_store  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.data.pipeline import EpochLoader  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.models.norm import batch_norm  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.ops.fused_loss import (  # noqa: E402
    fused_sharded_supcon_loss,
    fused_supcon_loss,
)
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.train import ce, linear, supcon  # noqa: E402
from simclr_pytorch_distributed_tpu_torch.train.state import (  # noqa: E402
    TrainState,
    make_optimizer,
)
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import (  # noqa: E402
    HEALTH_COV,
    SupConStepConfig,
    build_online_probe,
    train_step,
)
from simclr_pytorch_distributed_tpu_torch.utils import (  # noqa: E402
    checkpoint,
    convert,
    preempt,
    profiling,
)
from simclr_pytorch_distributed_tpu_torch.utils.guard import (  # noqa: E402
    NonFiniteLossError,
    RepresentationHealthError,
)
from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetrySession  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)
B, SIZE, FEAT, STEPS = 16, 16, 16, 2  # global batch, image size, feat_dim, steps
TEMP, BASE_TEMP = 0.5, 0.07
BN_SHAPE = (16, 6, 5, 5)  # the sync-BN case's global batch, NCHW
# name -> (--syncBN, loss_impl, method)
STEP_CASES = {
    "sync_fused_simclr": (True, "fused", "SimCLR"),
    "sync_dense_supcon": (True, "dense", "SupCon"),
    "local_fused_simclr": (False, "fused", "SimCLR"),
    "local_dense_simclr": (False, "dense", "SimCLR"),
}
# name -> (--syncBN, loss_impl, method, optimizer): the ring suite's steps
RING_STEP_CASES = {
    "sync_ring_simclr": (True, "ring", "SimCLR", "sgd"),
    "sync_ring_supcon": (True, "ring", "SupCon", "sgd"),
    "local_ring_simclr": (False, "ring", "SimCLR", "sgd"),
    "sync_ring_lars_simclr": (True, "ring", "SimCLR", "lars"),
}
# (method, temperature) of the ring loss cases
RING_LOSS_CASES = [(m, t) for m in ("SimCLR", "SupCon") for t in (0.5, 0.1)]
SCHED = dict(learning_rate=0.1, epochs=1, steps_per_epoch=STEPS, cosine=True)
STEP_KW = dict(temperature=TEMP, sec=True, sec_wei=0.5, l2reg=True, l2reg_wei=0.05,
               norm_momentum=0.6, epochs=1, steps_per_epoch=STEPS, grad_div=2.0)
DRIVER_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "16",
    "--batch_size", "16", "--learning_rate", "0.5", "--temp", "0.5", "--print_freq", "100",
    "--feat_dim", "16", "--loss_impl", "fused", "--epochs", "1", "--syncBN", "--seed", "3",
]
# the probe driver: rn10 on tiny_dataset (48 images a 3-step epoch at batch
# 16; 16 test images in validation chunks of 6, the tail of 4 padded). Seed
# 7 leaves a top-1 above 0, so the best classifier is written (one of 0
# never is, as in the reference)
PROBE_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--batch_size", "16",
    "--val_batch_size", "6", "--epochs", "1", "--learning_rate", "0.5", "--print_freq", "100",
    "--seed", "7",
]
# the resilience suite: --ngpu explicit, so the math is the world size's own
ELASTIC_ARGV = DRIVER_ARGV + ["--ngpu", "2", "--epochs", "2", "--cosine"]
ROLLBACK_ARGV = DRIVER_ARGV + ["--epochs", "2", "--cosine", "--nan_policy", "rollback"]


def bn_inputs():
    """``(x, dy, weight, bias, running_mean, running_var)`` of the sync-BN case."""
    rng = np.random.default_rng(21)
    c = BN_SHAPE[1]
    arrays = (rng.normal(0.3, 1.2, BN_SHAPE), rng.normal(0, 1, BN_SHAPE),
              rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c),
              rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in arrays)


def loss_inputs():
    """Unit ``[B, 2, D]`` features and ``[B]`` labels of the loss case."""
    rng = np.random.default_rng(31)
    f = rng.standard_normal((B, 2, FEAT)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return torch.from_numpy(f), torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))


def gather_inputs():
    """Global view-major rows ``[2B, D]`` and a cotangent of that shape."""
    rng = np.random.default_rng(41)
    return tuple(torch.from_numpy(rng.standard_normal((2 * B, FEAT)).astype(np.float32))
                 for _ in range(2))


def step_inputs():
    """``STEPS`` global batches of views ``[B, 2, SIZE, SIZE, 3]``, and labels."""
    rng = np.random.default_rng(11)
    views = rng.standard_normal((STEPS, B, 2, SIZE, SIZE, 3)).astype(np.float32)
    return torch.from_numpy(views), torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))


def init_model(feat=FEAT):
    """The rn10 of every step case, BN running buffers away from their init."""
    torch.manual_seed(5)
    model = SupConResNet("resnet10", "mlp", feat)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return model


def tiny_dataset(dataset, data_folder):
    """64 training images of uniform noise (4 steps of the driver case's
    batch of 16)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (80, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


def probe_dataset(dataset, data_folder):
    """The probe's set: 48 training images (a 3-step epoch at batch 16)
    and 16 test images, of :func:`tiny_dataset`."""
    train, test, n_cls = tiny_dataset(dataset, data_folder)
    return {k: v[:48] for k, v in train.items()}, test, n_cls


def local_slice(t, rank, world):
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b]


def sync_bn_case(rank, world):
    x, dy, weight, bias, ra_mean, ra_var = bn_inputs()
    bn = nn.BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(ra_mean)
        bn.running_var.copy_(ra_var)
    xl = local_slice(x, rank, world).clone().requires_grad_()
    y = batch_norm(bn, xl, torch.distributed.group.WORLD)
    y.backward(local_slice(dy, rank, world))
    return {"y": y.detach(), "dx": xl.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone(),
            "num_batches_tracked": bn.num_batches_tracked.clone()}


def gather_case():
    rows, cot = gather_inputs()
    local = collectives.own_rows(rows).clone().requires_grad_()
    out = collectives.gather_features(local)
    (out * cot).sum().backward()
    return {"out": out.detach(), "grad": local.grad}


def loss_case(rank, world, method):
    f, labels = loss_inputs()
    local = local_slice(f, rank, world).clone().requires_grad_()
    loss = fused_sharded_supcon_loss(local, labels if method == "SupCon" else None,
                                     temperature=TEMP, base_temperature=BASE_TEMP)
    loss.backward()
    out = {"loss": loss.detach(), "grad": local.grad}
    if world == 1:
        whole = f.clone().requires_grad_()
        ref = fused_supcon_loss(whole, labels if method == "SupCon" else None,
                                temperature=TEMP, base_temperature=BASE_TEMP)
        ref.backward()
        out.update(unsharded_loss=ref.detach(), unsharded_grad=whole.grad)
    return out


def step_case(name, rank, world, distributed, counted=None):
    """``STEPS`` steps of a step case: this process's slice under the process
    group (``distributed``), or the global batch without one; with
    ``counted`` (a :class:`Counted`) installed around the steps."""
    sync, loss_impl, method, *optimizer = {**STEP_CASES, **RING_STEP_CASES}[name]
    views, labels = step_inputs()
    model = init_model()
    if distributed and sync:
        model.encoder.set_bn_sync(torch.distributed.group.WORLD)
    state = TrainState(model, make_optimizer(model, optimizer=(optimizer or ["sgd"])[0]),
                       make_lr_schedule(**SCHED))
    cfg = SupConStepConfig(method=method, loss_impl=loss_impl, **STEP_KW)
    history = []
    with counted or contextlib.nullcontext():
        for i in range(STEPS):
            imgs, labs = views[i], labels
            if distributed:
                imgs, labs = local_slice(imgs, rank, world), local_slice(labs, rank, world)
            metrics = train_step(state, cfg, imgs, labs)
            history.append({k: v.item() for k, v in metrics.items()})
    out = {"history": history, "state": model.state_dict()}
    if counted is not None:
        out["counted"] = counted.summary()
    if distributed:
        flat = torch.cat([t.reshape(-1).float() for t in model.state_dict().values()])
        out["same_on_every_rank"] = all(torch.equal(p, flat) for p in collectives.all_gather(flat))
    return out


def driver_run(workdir, *extra, base=DRIVER_ARGV):
    """``train.supcon.main`` on the 64-image set; ``(exit code, result)``."""
    argv = base + ["--workdir", workdir] + list(extra)
    try:
        result = supcon.main(argv)
    except SystemExit as e:
        return e.code, None
    return 0, result


def preempted_after(steps, rank, world, run):
    """``run()`` with a signal raised on the last rank after global step
    ``steps``; returns ``run()``'s value and the losses of the steps taken."""
    losses = []

    def flagging(state, cfg, views, labels):
        metrics = train_step(state, cfg, views, labels)
        losses.append(metrics["loss"].item())
        if state.step == steps and rank == world - 1:
            preempt.request()
        return metrics

    supcon.train_step = flagging
    try:
        return run(), losses
    finally:
        supcon.train_step = train_step


def poisoned(at_steps, run):
    """``run()`` with a non-finite loss reported at each global step of
    ``at_steps`` (the driver's finite check raises there, as it would on a
    NaN); every process sees the same steps, as with a global loss."""
    check = supcon.check_finite_loss

    def poisoned_check(loss, step, enabled=True):
        if step in at_steps:
            raise NonFiniteLossError(float("nan"), step)
        return check(loss, step, enabled)

    supcon.check_finite_loss = poisoned_check
    try:
        return run()
    finally:
        supcon.check_finite_loss = check


def driver_summary(result):
    return {"losses": [h["loss"] for h in result.history], "state": result.state.model.state_dict(),
            "save_folder": result.save_folder, "step": result.state.step}


def driver_cases(rank, world, outdir):
    out = {}
    code, result = driver_run(os.path.join(outdir, "work_sync"))
    out["driver"] = dict(driver_summary(result), code=code)
    if world == 2:
        # a signal that reaches the last rank only, after global step 2
        # the preemption vote is taken at flush boundaries: one after step 2
        (out["preempt_code"], _), losses = preempted_after(
            2, rank, world, lambda: driver_run(os.path.join(outdir, "work_preempt"),
                                               "--print_freq", "2"))
        # every rank resumes from rank 0's preemption save
        folder = glob.glob(os.path.join(outdir, "work_preempt", "*_models", "*"))[0]
        code, result = driver_run(os.path.join(outdir, "work_resume"), "--resume", folder)
        out["resumed"] = dict(driver_summary(result), code=code)
        out["resumed"]["losses"] = losses + out["resumed"]["losses"]
        out["nonfinite_code"], _ = driver_run(os.path.join(outdir, "work_nan"),
                                              "--learning_rate", "inf")
    return out


def flags_case(world):
    out = {"none": preempt.requested_global()}
    if mesh.rank() == world - 1:
        preempt.request()
    out["last_rank"] = preempt.requested_global()
    preempt.uninstall()  # clears the flag
    return out


def count_writes():
    """Count this process's checkpoint file writes in ``writes``."""
    writes = []
    atomic_save = checkpoint._atomic_save

    def counted(obj, path):
        writes.append(os.path.basename(path))
        return atomic_save(obj, path)

    checkpoint._atomic_save = counted
    return writes


class Counted:
    """Counts, while installed, the ring's point-to-point hops
    (``batch_isend_irecv`` calls) in the ring loss's forward and backward,
    and the element count of every ``all_gather`` input."""

    def __init__(self):
        self.hops = {"fwd": 0, "bwd": 0}
        self.gathered = []
        self._phase = "fwd"
        dist, ring = torch.distributed, collectives.RingSupConLoss
        hop, gather, fwd, bwd = (dist.batch_isend_irecv, dist.all_gather, ring.forward,
                                 ring.backward)

        def counted_hop(ops):
            self.hops[self._phase] += 1
            return hop(ops)

        def counted_gather(parts, tensor, *args, **kwargs):
            self.gathered.append(tensor.numel())
            return gather(parts, tensor, *args, **kwargs)

        def phase(name, fn):
            def run(ctx, *args):
                self._phase = name
                return fn(ctx, *args)
            return staticmethod(run)

        # (owner, attribute, patch, the attribute as stored, to put back)
        self._patches = [(owner, name, patch, vars(owner)[name]) for owner, name, patch in (
            (dist, "batch_isend_irecv", counted_hop), (dist, "all_gather", counted_gather),
            (ring, "forward", phase("fwd", fwd)), (ring, "backward", phase("bwd", bwd)))]

    def __enter__(self):
        for owner, name, patch, _ in self._patches:
            setattr(owner, name, patch)
        return self

    def __exit__(self, *exc):
        for owner, name, _, original in self._patches:
            setattr(owner, name, original)

    def summary(self):
        return {"hops": dict(self.hops), "gathered": list(self.gathered)}


def ring_loss_case(rank, world, method, temp):
    f, labels = loss_inputs()
    local = local_slice(f, rank, world).clone().requires_grad_()
    with Counted() as counted:
        loss = collectives.ring_supcon_loss(local, labels if method == "SupCon" else None,
                                            temperature=temp, base_temperature=BASE_TEMP)
        loss.backward()
    return {"loss": loss.detach(), "grad": local.grad, "counted": counted.summary()}


def probe_run(workdir):
    """``train.linear.main`` on :func:`probe_dataset`; ``(exit code, summary)``."""
    try:
        result = linear.main(PROBE_ARGV + ["--workdir", workdir])
    except SystemExit as e:
        return {"code": e.code}
    return {"code": 0, "classifier": result.state.model.state_dict(),
            "val": result.val_history, "losses": [h["loss"] for h in result.history],
            "best": (result.best_acc, result.best_acc5), "path": result.classifier_path,
            "save_folder": result.save_folder}


def ring_suite(rank, world, outdir):
    """The ring loss per case, the ring steps (one of them counted), and at
    WORLD = 2 the probe driver."""
    out = {"loss": {case: ring_loss_case(rank, world, *case) for case in RING_LOSS_CASES}}
    out["step"] = {name: step_case(name, rank, world, True, Counted())
                   for name in RING_STEP_CASES}
    if world == 2:
        out["probe"] = probe_run(os.path.join(outdir, "work_probe"))
    return out


def run_summary(code, result, losses=()):
    """What the resilience tests compare of a driver run."""
    if result is None:
        return {"code": code}
    return dict(driver_summary(result), code=code,
                losses=list(losses) + [h["loss"] for h in result.history],
                lrs=[h["learning_rate"] for h in result.history],
                steps=[h["step"] for h in result.history])


def resilience_suite(rank, world, outdir, other_folder):
    """The straight elastic run, the run SIGTERM'd after global step 2, a
    resume from ``other_folder`` (saved under another world size), and a
    rollback run with a non-finite loss at global step 0."""
    out = {"straight": run_summary(*driver_run(os.path.join(outdir, "straight"),
                                               base=ELASTIC_ARGV))}
    (code, _), losses = preempted_after(
        2, rank, world,
        lambda: driver_run(os.path.join(outdir, "preempt"), "--print_freq", "2",
                           base=ELASTIC_ARGV))
    out["preempt"] = {"code": code, "losses": losses,
                      "folder": glob.glob(os.path.join(outdir, "preempt", "*_models", "*"))[0]}
    if other_folder:
        code, result = driver_run(os.path.join(outdir, "resumed"), "--resume", other_folder,
                                  base=ELASTIC_ARGV)
        out["resumed"] = run_summary(code, result)
        if result is not None:
            with open(os.path.join(result.save_folder, "log-ing")) as fh:
                out["resumed"]["log"] = fh.read()
    out["rollback"] = run_summary(*poisoned(
        {0}, lambda: driver_run(os.path.join(outdir, "rollback"), base=ROLLBACK_ARGV)))
    return out


# name -> (recipe, loss_impl) of the data-parallel recipe steps (all with
# --syncBN); under the ring a non-contrastive recipe gathers the rows
RECIPE_STEP_CASES = {"byol": ("byol", "dense"), "vicreg": ("vicreg", "dense"),
                     "byol_ring": ("byol", "ring")}


def recipe_case(name, rank, world, distributed):
    """``STEPS`` steps of recipe case ``name``: this process's slice under
    the process group with cross-replica BN, or the global batch without
    one. Returns the history, the model's state and the recipe slots (the
    predictor's and the EMA network's parameters by name)."""
    recipe, loss_impl = RECIPE_STEP_CASES[name]
    views, labels = step_inputs()
    model = init_model()
    if distributed:
        model.encoder.set_bn_sync(torch.distributed.group.WORLD)
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**SCHED))
    cfg = config_lib.SupConConfig(recipe=recipe, feat_dim=FEAT, predictor_hidden=32,
                                  batch_size=B, ema_momentum=0.9)
    config_lib.validate_recipe(cfg)
    recipes.attach_for_config(cfg, state)
    step_cfg = SupConStepConfig(method="SimCLR", loss_impl=loss_impl, **STEP_KW)
    history = []
    for i in range(STEPS):
        imgs = local_slice(views[i], rank, world) if distributed else views[i]
        metrics = train_step(state, step_cfg, imgs, labels)
        history.append({k: v.item() for k, v in metrics.items()})
    slots = {}
    if state.recipe_params is not None:
        slots.update({f"predictor.{k}": v.detach().clone()
                      for k, v in state.recipe_params.state_dict().items()})
    for key, net in (state.recipe_state or {}).items():
        slots.update({f"{key}.{k}": p.detach().clone() for k, p in net.named_parameters()})
    out = {"history": history, "state": model.state_dict(), "slots": slots}
    if distributed:
        flat = torch.cat([t.reshape(-1).float() for t in [*model.state_dict().values(),
                                                            *slots.values()]])
        out["same_on_every_rank"] = all(torch.equal(p, flat) for p in collectives.all_gather(flat))
    return out


def boundary_preempt_case(rank, world, outdir):
    """The driver with ``--print_freq 3`` (4 steps an epoch): straight, and
    with a signal on the last rank after step 1, between flush boundaries,
    then resumed; each run's preemption votes counted."""
    argv = ["--print_freq", "3"]
    vote = preempt.requested_global
    votes = []

    def counted():
        votes.append(1)
        return vote()

    preempt.requested_global = counted
    try:
        code, straight = driver_run(os.path.join(outdir, "b_straight"), *argv)
        assert code == 0
        straight_votes = len(votes)
        votes.clear()
        (code, _), losses = preempted_after(
            1, rank, world, lambda: driver_run(os.path.join(outdir, "b_preempt"), *argv))
        preempt_votes = len(votes)
    finally:
        preempt.requested_global = vote
    folder = glob.glob(os.path.join(outdir, "b_preempt", "*_models", "*"))[0]
    _, resumed = driver_run(os.path.join(outdir, "b_resume"), *argv, "--resume", folder)
    want, got = straight.state.model.state_dict(), resumed.state.model.state_dict()
    return {
        "preempt_code": code, "votes": preempt_votes, "straight_votes": straight_votes,
        "saved": sorted(os.path.basename(p) for p in glob.glob(os.path.join(folder, "*.pth"))),
        "straight_losses": [h["loss"] for h in straight.history],
        "resumed_losses": losses + [h["loss"] for h in resumed.history],
        "resumed_equal": all(torch.equal(got[k], want[k]) for k in want),
    }


# the tp suite: model shards, and name -> (--syncBN, loss_impl, method,
# optimizer); the ring cases run at WORLD = 4 only (a data axis of 2)
TP = 2
TP_STEP_CASES = {
    "sync_fused_simclr": (True, "fused", "SimCLR", "sgd"),
    "sync_dense_supcon": (True, "dense", "SupCon", "sgd"),
    "local_fused_simclr": (False, "fused", "SimCLR", "sgd"),
    "local_dense_simclr": (False, "dense", "SimCLR", "sgd"),
    "sync_dense_lars_simclr": (True, "dense", "SimCLR", "lars"),
    "sync_ring_simclr": (True, "ring", "SimCLR", "sgd"),
    "local_ring_simclr": (False, "ring", "SimCLR", "sgd"),
}
TP_RING_CASES = ("sync_ring_simclr", "local_ring_simclr")
# at WORLD = 3 the grid is one model group of 3 and the head's output is 96
# wide: every rn10 width fails % 3 and is replicated, and the head's last
# linear, sharded, reads the whole replicated hidden layer
TP_MIXED, TP_MIXED_FEAT = 3, 96
TP_MIXED_CASES = ("sync_dense_supcon", "sync_dense_lars_simclr")
# the tp driver: two 4-step epochs, a save after each
TP_DRIVER_ARGV = DRIVER_ARGV + ["--epochs", "2", "--save_freq", "1", "--print_freq", "4"]


# the tp suite's recipe cases (--syncBN, the dense loss): name -> SupConConfig
# overrides. A 128-wide predictor: at N = 2 its fc1 and normalization are
# sharded and fc2 (16 wide) is replicated and reads the gathered hidden
# layer; at N = 3 (TP_MIXED, the 96-wide head) fc1 and the normalization
# are replicated and fc2 is sharded, reading the whole hidden layer, which
# carries a gradient. The queue's K = 64 is a multiple of 2B and would pass
# the dim-0 rule at N = 2, were the rule ever to read it
TP_RECIPE_CASES = {
    "byol": dict(recipe="byol"),
    "simsiam": dict(recipe="simsiam"),
    "vicreg": dict(recipe="vicreg"),
    "simclr_queue": dict(recipe="simclr", moco_queue=64),
}
TP_RECIPE_HIDDEN, TP_RECIPE_EMA = 128, 0.9
TP_MIXED_RECIPE_CASES = ("byol",)
# the tp recipe driver at 8 px: three 4-step epochs; the N = 2 run, its
# first epoch's save resumed at N = 1, and that run's second epoch's save
# resumed at N = 2, so each resume's first epoch is held against the run it
# continues
TP_RECIPE_DRIVER_ARGV = DRIVER_ARGV + [
    "--size", "8", "--epochs", "3", "--save_freq", "1", "--print_freq", "4",
    "--predictor_hidden", str(TP_RECIPE_HIDDEN), "--loss_impl", "dense"]
TP_RECIPE_DRIVER_SAVES = ("ckpt_epoch_2.pth", "last.pth")
TP_RECIPE_DRIVER_CASES = {"byol": ["--recipe", "byol"],
                          "simclr_queue": ["--recipe", "simclr", "--moco_queue", "64"]}


def tp_recipe_config(name, feat=FEAT):
    cfg = config_lib.SupConConfig(**TP_RECIPE_CASES[name], feat_dim=feat, batch_size=B,
                                  predictor_hidden=TP_RECIPE_HIDDEN, ema_momentum=TP_RECIPE_EMA)
    config_lib.validate_recipe(cfg)
    return cfg


def tp_recipe_init(name, feat=FEAT):
    """The whole init of a recipe case as numpy trees, the JAX package's
    layout: ``(variables, slots)`` of the step cases' rn10 and the recipe
    slots that one process attaches to it (``utils/convert``)."""
    model = init_model(feat)
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**SCHED))
    recipes.attach_for_config(tp_recipe_config(name, feat), state)
    return (convert.state_dict_to_variables(model.state_dict()),
            convert.recipe_slots_from_torch(state.recipe_params, state.recipe_state))


def recipe_slot_tensors(state):
    """The recipe slots of ``state`` by name: the predictor's parameters
    (``predictor.*``) and momentum (``predictor_momentum.*``), each EMA
    network's parameters (``target.*``, ``key.*``), ``queue_emb`` and
    ``queue_ptr`` (a 0-dim tensor)."""
    out = {}
    if state.recipe_params is not None:
        out.update({f"predictor.{k}": v.detach().clone()
                    for k, v in state.recipe_params.state_dict().items()})
        opt = state.recipe_opt_state
        out.update({f"predictor_momentum.{n}": opt.state[p]["momentum_buffer"].clone()
                    for n, p in state.recipe_params.named_parameters() if p in opt.state})
    for key, value in (state.recipe_state or {}).items():
        if isinstance(value, nn.Module):
            out.update({f"{key}.{k}": p.detach().clone() for k, p in value.named_parameters()})
        else:
            out[key] = torch.as_tensor(value).clone()
    return out


def tp_recipe_case(name, distributed, feat=FEAT):
    """``STEPS`` steps of recipe case ``name`` from the converted whole init
    (:func:`tp_recipe_init`): under the grid on this process's data slice,
    with this process's shards of the weights and the slots
    (``convert.variables_to_shard_state_dict``,
    ``recipe_slots_to_shard_torch``), or the global batch on one process.
    Returns the history, the state dict, the slots, and whether the slots
    the recipe attached under the grid were the converted ones bitwise."""
    variables, slots = tp_recipe_init(name, feat)
    views, labels = step_inputs()
    model = init_model(feat)
    n, index = (mesh.model_parallel(), mesh.model_index()) if distributed else (1, 0)
    if distributed:
        model.encoder.set_bn_sync(mesh.data_group())
        mesh.shard_module(model, n, index)
    model.load_state_dict(convert.variables_to_shard_state_dict(variables, n, index))
    opt = make_optimizer(model, model_group=mesh.model_group() if distributed else None)
    state = TrainState(model, opt, make_lr_schedule(**SCHED))
    recipes.attach_for_config(tp_recipe_config(name, feat), state)
    attached = recipe_slot_tensors(state)
    checkpoint.restore_recipe_slots(convert.recipe_slots_to_shard_torch(n, index, **slots), state)
    restored = recipe_slot_tensors(state)
    cfg = SupConStepConfig(method="SimCLR", loss_impl="dense", **STEP_KW)
    history = []
    for i in range(STEPS):
        imgs, labs = views[i], labels
        if distributed:
            d, n_data = mesh.data_index(), mesh.data_parallel()
            imgs, labs = local_slice(imgs, d, n_data), local_slice(labs, d, n_data)
        metrics = train_step(state, cfg, imgs, labs)
        history.append({k: v.item() for k, v in metrics.items()})
    return {"history": history, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "slots": recipe_slot_tensors(state),
            "init_is_converted": attached.keys() == restored.keys() and all(
                torch.equal(attached[k], restored[k]) for k in attached)}


def tp_recipe_driver_cases(outdir):
    """Each of ``TP_RECIPE_DRIVER_CASES`` through the driver: straight at N
    = 2, its first epoch's save resumed at N = 1, and that run's second
    epoch's save resumed at N = 2; rank 0 returns each run's losses, the
    model and recipe payload of those of its saves of
    ``TP_RECIPE_DRIVER_SAVES`` that it wrote, and its log."""
    out = {}
    for name, extra in TP_RECIPE_DRIVER_CASES.items():
        runs, folder = {}, {}
        plan = (("n2", 2, None), ("resume_2_1", 1, ("n2", 1)), ("resume_1_2", 2, ("resume_2_1", 2)))
        for key, n, src in plan:
            resume = [] if src is None else [
                "--resume", os.path.join(folder[src[0]], f"ckpt_epoch_{src[1]}.pth")]
            code, result = driver_run(os.path.join(outdir, f"tpr_{name}_{key}"),
                                      "--model_parallel", str(n), *extra, *resume,
                                      base=TP_RECIPE_DRIVER_ARGV)
            runs[key] = {"code": code}
            if result is not None:
                folder[key] = result.save_folder
                if mesh.is_main_process():
                    with open(os.path.join(result.save_folder, "log-ing")) as fh:
                        log = fh.read()
                    runs[key].update(losses=[h["loss"] for h in result.history], log=log)
                    for save in TP_RECIPE_DRIVER_SAVES:
                        path = os.path.join(result.save_folder, save)
                        if os.path.exists(path):
                            saved = torch.load(path, weights_only=True)
                            runs[key][save] = {k: saved[k] for k in ("model", "recipe")}
        out[name] = runs
        # the runs' saves are read: leave none behind
        mesh.sync_processes("tp recipe driver saves read")
        if mesh.is_main_process():
            for path in glob.glob(os.path.join(outdir, f"tpr_{name}_*")):
                shutil.rmtree(path, ignore_errors=True)
    return out


def tp_layout(world):
    """``(--model_parallel, feat_dim)`` of the tp suite at ``world``."""
    return (TP_MIXED, TP_MIXED_FEAT) if world == TP_MIXED else (TP, FEAT)


def tp_cases(world):
    if world == TP_MIXED:
        return list(TP_MIXED_CASES)
    return [n for n in TP_STEP_CASES if world == 4 or n not in TP_RING_CASES]


def tp_step_case(name, distributed, feat=FEAT):
    """``STEPS`` steps of a tp case: under the grid on this process's data
    slice and shards (``distributed``), or the global batch and the whole
    model without a process group. Returns the losses, the state dict,
    the momentum buffers by parameter name and the health gradient norms."""
    sync, loss_impl, method, optimizer = TP_STEP_CASES[name]
    views, labels = step_inputs()
    model = init_model(feat)
    if distributed:
        if sync:
            model.encoder.set_bn_sync(mesh.data_group())
        mesh.shard_module(model, mesh.model_parallel(), mesh.model_index())
    opt = make_optimizer(model, optimizer=optimizer,
                         model_group=mesh.model_group() if distributed else None)
    state = TrainState(model, opt, make_lr_schedule(**SCHED))
    cfg = SupConStepConfig(method=method, loss_impl=loss_impl, health_freq=1, **STEP_KW)
    losses, grad_norms = [], []
    for i in range(STEPS):
        imgs, labs = views[i], labels
        if distributed:
            d, n_data = mesh.data_index(), mesh.data_parallel()
            imgs, labs = local_slice(imgs, d, n_data), local_slice(labs, d, n_data)
        metrics = train_step(state, cfg, imgs, labs)
        losses.append(metrics["loss"].item())
        grad_norms.append(metrics["health_grad_norm"].item())
    momentum = {n: opt.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters()}
    return {"losses": losses, "grad_norms": grad_norms, "momentum": momentum,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def tp_driver_cases(outdir):
    """The driver at ``--model_parallel`` 2 and 1, then each resumed from
    the other's first-epoch save; rank 0 returns each run's losses and
    ``last.pth``."""
    out, ckpt = {}, {}

    def report(key, code, result):
        out[key] = {"code": code}
        if result is not None and mesh.is_main_process():
            saved = torch.load(os.path.join(result.save_folder, "last.pth"), weights_only=True)
            out[key].update(losses=[h["loss"] for h in result.history], last=saved)
        if result is not None:
            ckpt[key] = os.path.join(result.save_folder, "ckpt_epoch_1.pth")

    for n in (2, 1):
        report(f"n{n}", *driver_run(os.path.join(outdir, f"tp_n{n}"), "--model_parallel",
                                    str(n), base=TP_DRIVER_ARGV))
    for src, dst in ((2, 1), (1, 2)):
        report(f"resume_{src}_{dst}", *driver_run(
            os.path.join(outdir, f"tp_resume_{src}_{dst}"), "--model_parallel", str(dst),
            "--resume", ckpt[f"n{src}"], base=TP_DRIVER_ARGV))
    # the runs' saves are read: leave no checkpoint behind
    mesh.sync_processes("tp driver saves read")
    if mesh.is_main_process():
        for name in ("tp_n2", "tp_n1", "tp_resume_2_1", "tp_resume_1_2"):
            shutil.rmtree(os.path.join(outdir, name), ignore_errors=True)
    return out


def tp_suite(rank, world, outdir):
    out = {}
    if world == 2:
        # the data-parallel step without a grid, then under a grid of N = 1
        before = step_case("sync_fused_simclr", rank, world, True)
        mesh.setup_grid(1)
        out["n1"] = {"before": before,
                     "after": step_case("sync_fused_simclr", rank, world, True)}
    n, feat = tp_layout(world)
    mesh.setup_grid(n)
    ranks = lambda g: torch.distributed.get_process_group_ranks(g)  # noqa: E731
    out["grid"] = {"data_index": mesh.data_index(), "model_index": mesh.model_index(),
                   "data_parallel": mesh.data_parallel(),
                   "model_parallel": mesh.model_parallel(),
                   "data_group": ranks(mesh.data_group()),
                   "model_group": ranks(mesh.model_group())}
    # one case with its collectives counted by group (counting changes no value)
    counted = "sync_dense_supcon" if world == TP_MIXED else "sync_fused_simclr"
    out["step"] = {}
    for name in tp_cases(world):
        run = lambda: out["step"].__setitem__(name, tp_step_case(name, True, feat))  # noqa: E731
        if name == counted:
            out["collectives"] = profiling.count_collectives(run)
        else:
            run()
    out["recipe"] = {name: tp_recipe_case(name, True, feat) for name in
                     (TP_MIXED_RECIPE_CASES if world == TP_MIXED else TP_RECIPE_CASES)}
    if world == 2:
        out["driver"] = tp_driver_cases(outdir)
        out["recipe_driver"] = tp_recipe_driver_cases(outdir)
    return out


def parallel_suite(rank, world, outdir):
    results = {
        "world": mesh.world_size(), "rank": mesh.rank(),
        "sync_bn": sync_bn_case(rank, world),
        "gather": gather_case(),
        "loss": {m: loss_case(rank, world, m) for m in ("SimCLR", "SupCon")},
        "flags": flags_case(world),
        "step": {name: step_case(name, rank, world, True) for name in STEP_CASES},
    }
    results.update(driver_cases(rank, world, outdir))
    return results


# failure-code cases: name -> the failure of each rank's flush (None: clean)
FAILURE_CASES = {
    "clean": (None, None),
    "nan_on_one_rank": (None, "nan"),
    "flush_beats_nan": ("nan", "flush"),
    "health_beats_flush": ("flush", "health"),
}
FAILURES = {
    "nan": lambda: NonFiniteLossError(float("nan"), 3),
    "flush": lambda: OSError("disk full"),
    "health": lambda: RepresentationHealthError(["collapse"], 3),
}
# the health/probe step cases (a subset of STEP_CASES and RING_STEP_CASES)
HEALTH_CASES = ("sync_fused_simclr", "sync_ring_simclr")
HEALTH_PROBE_CLASSES = 4


def failure_exchange_case(rank, name):
    """What this rank raises at a boundary when the ranks' flushes failed
    as ``FAILURE_CASES[name]`` says: the exception's type name, or 'none'."""
    session = TelemetrySession(4, ("loss",), "async")
    failure = FAILURE_CASES[name][rank]
    if failure is not None:
        def job():
            raise FAILURES[failure]()
        session.executor.submit(job)
    session.executor.wait_idle()
    try:
        session.check_failures_global(step_hint=3)
        return "none"
    except BaseException as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__
    finally:
        session.close()


def health_step_case(name, rank, world, distributed):
    """``STEPS`` steps of a step case with the health diagnostics every step
    and the online probe: each step's scalar metrics, the health
    covariance, and the probe classifier after the steps."""
    sync, loss_impl, method, *_ = {**STEP_CASES, **RING_STEP_CASES}[name]
    views, labels = step_inputs()
    model = init_model()
    if distributed and sync:
        model.encoder.set_bn_sync(torch.distributed.group.WORLD)
    state = TrainState(model, make_optimizer(model), make_lr_schedule(**SCHED))
    state.probe = build_online_probe("resnet10", HEALTH_PROBE_CLASSES, 0.1, seed=9)
    cfg = SupConStepConfig(method=method, loss_impl=loss_impl, health_freq=1,
                           online_probe=True, **STEP_KW)
    history = []
    for i in range(STEPS):
        imgs, labs = views[i], labels
        if distributed:
            imgs, labs = local_slice(imgs, rank, world), local_slice(labs, rank, world)
        metrics = train_step(state, cfg, imgs, labs)
        history.append({k: (v.clone() if k == HEALTH_COV else v.item())
                        for k, v in metrics.items()})
    return {"history": history, "probe": state.probe.classifier.state_dict()}


def telemetry_suite(rank, world, outdir):
    return {
        "failures": {name: failure_exchange_case(rank, name) for name in FAILURE_CASES},
        "health": {name: health_step_case(name, rank, world, True) for name in HEALTH_CASES},
    }


CE_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--batch_size", "16",
    "--val_batch_size", "8", "--epochs", "1", "--learning_rate", "0.01", "--print_freq", "100",
    "--syncBN", "--seed", "3",
]


def ce_run(workdir, *extra):
    """``train.ce.main`` on :func:`tiny_dataset`; ``(exit code, result)``."""
    try:
        return 0, ce.main(CE_ARGV + ["--workdir", workdir] + list(extra))
    except SystemExit as e:
        return e.code, None


def ce_summary(code, result):
    if result is None:
        return {"code": code}
    return {"code": code, "losses": [h["loss"] for h in result.history],
            "top1": [h["top1"] for h in result.history], "val": result.val_history,
            "state": result.state.model.state_dict(), "step": result.state.step,
            "best_acc": result.best_acc, "save_folder": result.save_folder}


def ce_suite(rank, world, outdir):
    return {"ce": ce_summary(*ce_run(os.path.join(outdir, "ce")))}


PLACEMENT_BATCH, PLACEMENT_WINDOW = 8, 2


def placement_dataset():
    """40 images of 8 px: 5 steps of :data:`PLACEMENT_BATCH`."""
    rng = np.random.default_rng(1)
    return (rng.integers(0, 256, (40, 8, 8, 3), dtype=np.uint8),
            rng.integers(0, 10, 40).astype(np.int32))


def placement_suite(rank, world, outdir):
    """Rank 0's budget holds the resident store, the others' only the
    window: 'auto' must give 'window' on every process, and 'device' raise
    on every process. With a tiny budget on the others, 'auto' gives 'host'
    everywhere."""
    images, labels = placement_dataset()
    b, w = PLACEMENT_BATCH, PLACEMENT_WINDOW
    need_res = device_store.resident_bytes_per_device(images, labels, b, world)
    need_win = device_store.windowed_bytes_per_device(images, labels, b, world, w)
    own = need_res if rank == 0 else (need_res + need_win) // 2

    def resolve(placement, budget):
        return device_store.resolve_data_placement(placement, images, labels, b, world,
                                                   budget_bytes=budget, window_batches=w)

    out = {"auto_mixed": resolve("auto", own),
           "auto_host": resolve("auto", need_res if rank == 0 else 10)}
    try:
        resolve("device", own)
        out["device_error"] = ""
    except ValueError as e:
        out["device_error"] = str(e)
    loader = EpochLoader(images, labels, b, base_seed=2, process_index=rank,
                         process_count=world)
    store = device_store.make_store("auto", loader, torch.device("cpu"), own, w)
    out["store"] = type(store).__name__
    out["batches"] = [tuple(t.numpy().copy() for t in store.batch(epoch, idx))
                      for epoch in (1, 2) for idx in range(len(loader))]
    store.close()
    return out


SKEW_PACE_S, SKEW_BOUNDARIES = 0.15, 4


def skew_suite(rank, world, outdir):
    """Boundary exchanges with the last rank paced, as ``skew`` says: for
    each boundary the gauges after it, the ``boundary_skew`` events, and
    the calls of each collective during all of them."""
    from simclr_pytorch_distributed_tpu_torch.utils import tracing
    from simclr_pytorch_distributed_tpu_torch.utils.prom import TrainerGauges
    import torch.distributed as dist

    calls = {}
    originals = {name: getattr(dist, name) for name in
                 ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast")}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    recorder = tracing.FlightRecorder()
    tracing.install(recorder)
    gauges = TrainerGauges()
    session = TelemetrySession(4, ("loss",), "async", gauges=gauges)
    after = []
    for name, fn in originals.items():
        setattr(dist, name, counted(name, fn))
    try:
        for b in range(SKEW_BOUNDARIES):
            if rank == world - 1:
                time.sleep(SKEW_PACE_S)
            session.check_failures_global(step_hint=b)
            after.append(gauges.collect())
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
        session.close()
        tracing.uninstall()
    events = [r for r in recorder.snapshot() if r["name"] == "boundary_skew"]
    return {"gauges": after, "events": events, "calls": calls}


def fleet_main(rank, world, outdir, arg):
    """The ``fleet`` suite (module docstring); exits with the driver's code."""
    spec = json.loads(arg)
    pace_ms = float(os.environ.get("FLEET_STRAGGLER_MS", "0") or 0)
    if pace_ms and rank == int(os.environ.get("FLEET_STRAGGLER_PID", "1")):
        exchange = TelemetrySession.check_failures_global

        def late(self, step_hint=0):
            time.sleep(pace_ms / 1e3)
            return exchange(self, step_hint)

        TelemetrySession.check_failures_global = late
    extra = ["--epochs", str(spec["epochs"]), "--size", "8", "--print_freq", "1",
             "--save_freq", "1", "--trial", "fleet"]
    port = os.environ.get("CHILD_METRICS_PORT", "")
    if port:
        extra += ["--metrics_port", port]
    if spec.get("resume"):
        extra += ["--resume", spec["resume"]]
    code, result = driver_run(spec["workdir"], *extra)
    if result is not None:
        digest = hashlib.sha256()
        for key, t in result.state.model.state_dict().items():
            digest.update(key.encode())
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        print(f"DRIVER step={result.state.step} digest={digest.hexdigest()} "
              f"save_folder={result.save_folder}", flush=True)
    mesh.teardown_distributed()
    sys.exit(code or 0)


def spawn(world, outdir, suite, arg="", wall_limit=300):
    """Run ``world`` processes of ``suite`` to the end (one thread each) and
    return their results, rank by rank; a failed or overrunning process
    kills its peers."""
    return collect(start(world, outdir, suite, arg), outdir, wall_limit)


def start(world, outdir, suite, arg=""):
    """Start ``world`` processes of ``suite`` (one thread each) and return
    them, for :func:`collect`."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(outdir, exist_ok=True)
    procs = []
    for r in range(world):
        # the output goes to a file: a pipe nobody reads while the test waits
        # on another spawn would fill and stall the process
        with open(os.path.join(outdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(world), str(outdir), suite]
                + ([arg] if arg else []), env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs, outdir, wall_limit=300):
    """Wait for processes :func:`start` started and return their results,
    rank by rank; a failed or overrunning process kills its peers."""
    world = len(procs)
    deadline = time.monotonic() + wall_limit
    try:
        for r, proc in enumerate(procs):
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                with open(os.path.join(outdir, f"rank{r}.log")) as fh:
                    out = fh.read()
                raise AssertionError(f"rank {r} of {world} exited {proc.returncode}:\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main(rank, world, outdir, suite="parallel", arg=""):
    torch.set_num_threads(1)
    supcon.load_dataset = tiny_dataset
    linear.load_dataset = probe_dataset
    ce.load_dataset = tiny_dataset
    writes = count_writes()
    mesh.setup_distributed("cpu", init_method=f"file://{os.path.join(outdir, 'store')}",
                           rank=rank, world_size=world, timeout=TIMEOUT)
    if suite == "fleet":
        fleet_main(rank, world, outdir, arg)
    if suite == "parallel":
        results = parallel_suite(rank, world, outdir)
    elif suite == "ring":
        results = ring_suite(rank, world, outdir)
    elif suite == "resilience":
        results = resilience_suite(rank, world, outdir, arg)
    elif suite == "telemetry":
        results = telemetry_suite(rank, world, outdir)
    elif suite == "ce":
        results = ce_suite(rank, world, outdir)
    elif suite == "placement":
        results = placement_suite(rank, world, outdir)
    elif suite == "recipes":
        results = {name: recipe_case(name, rank, world, True) for name in RECIPE_STEP_CASES}
        results["preempt_boundary"] = boundary_preempt_case(rank, world, outdir)
    elif suite == "skew":
        results = skew_suite(rank, world, outdir)
    elif suite == "tp":
        results = tp_suite(rank, world, outdir)
    else:
        raise ValueError(f"unknown suite {suite!r}")
    results["writes"] = list(writes)
    mesh.teardown_distributed()
    if world == 1 and suite == "parallel":
        # the one-process references, with no process group
        results["step_single"] = {name: step_case(name, 0, 1, False) for name in STEP_CASES}
        code, result = driver_run(os.path.join(outdir, "work_single"))
        results["driver_single"] = dict(driver_summary(result), code=code)
    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
