"""The port's ring-sharded loss, its train step, the share splits and the
probe over several processes (gloo, CPU).

One module-scoped fixture per world size P in {2, 4} spawns P processes of
``tests/torch_parallel_child.py`` (suite ``ring``); P = 1 runs here, with
no process group. Each comparison is its own parametrised case:

- ``ring_supcon_loss`` (SimCLR and SupCon; tau 0.5 and 0.1) against the
  port's dense ``supcon_loss`` and the JAX package's ``ops.losses.supcon_loss``
  on the global batch: the loss at rtol 2e-5 (the JAX ring pin,
  ``tests/test_ring_loss.py``), each process's feature gradient at atol
  1e-5 x max|dF| of the dense gradient's rows for that process;
- counted: no ``all_gather`` of the features in a ring step (every gathered
  tensor is far smaller than a process's ``[2b, D]`` rows), ``P - 1``
  point-to-point hops in the loss's forward and ``P`` in its backward (at
  most ``P`` each; none at P = 1);
- the P-process ring step (with ``--syncBN``, SimCLR and SupCon, and with
  LARS) against the one-process dense step and the JAX package's
  one-device step at the JAX package's pins (loss rtol 2e-5; parameters and
  buffers rtol 1e-3 / atol 2e-5, ``tests/test_distributed.py:69-77``);
  without ``--syncBN`` against the JAX model with ``bn_local_groups=P``;
- ``share_splits``/``parse_share_hint`` on the JAX package's own cases
  (``tests/test_data.py``) against the JAX functions, and the union of the
  ``EpochLoader(share_hint=...)`` slices being the global batch;
- the probe driver (``train.linear.main``) in 2 processes against 1: the
  classifier within 1e-5 relative after its 3 steps, validation top-1 and
  top-5 exactly equal, only rank 0 writing.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.data.pipeline import EpochLoader as JaxEpochLoader
from simclr_pytorch_distributed_tpu.data.pipeline import parse_share_hint as jax_parse_hint
from simclr_pytorch_distributed_tpu.data.pipeline import share_splits as jax_share_splits
from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.ops.losses import supcon_loss as jax_supcon_loss
from simclr_pytorch_distributed_tpu.ops.schedules import (
    make_lr_schedule as jax_make_lr_schedule,
)
from simclr_pytorch_distributed_tpu.train import state as jax_state
from simclr_pytorch_distributed_tpu.train import supcon_step as jax_step
from simclr_pytorch_distributed_tpu_torch.data.pipeline import (
    EpochLoader,
    parse_share_hint,
    share_splits,
)
from simclr_pytorch_distributed_tpu_torch.ops.losses import supcon_loss
from simclr_pytorch_distributed_tpu_torch.train import linear, supcon
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import CLASSIFIER_FILE
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()

WORLDS = (1, 2, 4)
WALL_LIMIT = 300  # seconds for one world's processes, spawn to exit
RING_LOSS_RTOL, GRAD_SCALED_ATOL = 2e-5, 1e-5
STEP_LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-3, 2e-5  # tests/test_distributed.py
PROBE_REL = 1e-5


def _spawn(world, outdir):
    """Run ``world`` child processes of the ring suite to the end and return
    their results, rank by rank; a failed or overrunning child kills its
    peers."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = child.REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, child.__file__, str(r), str(world), str(outdir),
                          "ring"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
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


def _in_process():
    """The ring suite's cases at P = 1, in this process, with no group."""
    with torch.random.fork_rng():
        out = {"loss": {case: child.ring_loss_case(0, 1, *case)
                        for case in child.RING_LOSS_CASES},
               "step": {name: child.step_case(name, 0, 1, False, child.Counted())
                        for name in child.RING_STEP_CASES}}
    return [out]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``results(P)``: the P processes' results, computed once per module."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = (_in_process() if world == 1
                           else _spawn(world, tmp_path_factory.mktemp(f"ring{world}")))
        return done[world]

    return get


# -- the ring loss -----------------------------------------------------------

def dense_reference(method, temp):
    """The port's dense loss and gradient on the global batch, and the JAX
    package's loss."""
    f, labels = child.loss_inputs()
    labels = labels if method == "SupCon" else None
    whole = f.clone().requires_grad_()
    loss = supcon_loss(whole, labels, temperature=temp, base_temperature=child.BASE_TEMP)
    loss.backward()
    jax_loss = float(jax_supcon_loss(
        jnp.asarray(f.numpy()), None if labels is None else jnp.asarray(labels.numpy()),
        temperature=temp, base_temperature=child.BASE_TEMP))
    return loss.item(), jax_loss, whole.grad


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", child.RING_LOSS_CASES, ids=lambda c: f"{c[0]}-t{c[1]}")
def test_ring_loss_matches_dense(results, world, case):
    loss, jax_loss, grad = dense_reference(*case)
    ranks = results(world)
    for r, got in enumerate(ranks):
        got = got["loss"][case]
        np.testing.assert_allclose(got["loss"].item(), loss, rtol=RING_LOSS_RTOL)
        np.testing.assert_allclose(got["loss"].item(), jax_loss, rtol=RING_LOSS_RTOL)
        want = child.local_slice(grad, r, world)
        err = (got["grad"] - want).abs().max().item()
        assert err <= GRAD_SCALED_ATOL * grad.abs().max().item(), (r, err)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_loss_hops(results, world):
    for got in results(world):
        hops = got["loss"][("SimCLR", 0.5)]["counted"]["hops"]
        assert hops == {"fwd": world - 1, "bwd": world if world > 1 else 0}, hops


# -- the ring step -----------------------------------------------------------

RING_SYNC = [name for name, (sync, *_) in child.RING_STEP_CASES.items() if sync]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(child.RING_STEP_CASES))
def test_ring_step_gathers_no_features(results, world, case):
    """At most P hops each way a step, and every all_gather (labels, loss
    and norm sums, BN statistics) far smaller than the ``[2b, D]`` rows."""
    rows = 2 * child.B // world * child.FEAT
    for got in results(world):
        counted = got["step"][case]["counted"]
        per_step = {k: n / child.STEPS for k, n in counted["hops"].items()}
        assert per_step == {"fwd": world - 1, "bwd": world if world > 1 else 0}, per_step
        assert all(n < rows for n in counted["gathered"]), counted["gathered"]


@functools.cache
def one_process_dense(case):
    """The case's steps without a process group, with the dense loss (once
    per case)."""
    sync, _, method, optimizer = child.RING_STEP_CASES[case]
    key = f"dense_{method}_{optimizer}"
    child.RING_STEP_CASES[key] = (sync, "dense", method, optimizer)
    try:
        with torch.random.fork_rng():
            return child.step_case(key, 0, 1, False)
    finally:
        del child.RING_STEP_CASES[key]


@functools.cache
def jax_steps(groups, method, optimizer):
    """The JAX package's one-device dense step over the global batches from
    the step cases' init: ``(losses, final torch-layout state dict)``, once
    per argument triple."""
    views, labels = child.step_inputs()
    variables = state_dict_to_variables(child.init_model().state_dict())
    jmodel = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=child.FEAT,
                             sync_bn=groups == 1, bn_local_groups=groups,
                             bn_group_views=2)
    schedule = jax_make_lr_schedule(**child.SCHED)
    tx = jax_state.make_optimizer(schedule, momentum=0.9, weight_decay=1e-4,
                                  optimizer=optimizer)
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
    return losses, variables_to_state_dict({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats})


def assert_same_step(got, want_losses, want_state):
    np.testing.assert_allclose([h["loss"] for h in got["history"]], want_losses,
                               rtol=STEP_LOSS_RTOL)
    for key, ref in want_state.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][key].numpy(), ref.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", RING_SYNC)
def test_ring_step_matches_one_process_dense(results, world, case):
    single = one_process_dense(case)
    assert_same_step(results(world)[0]["step"][case], [h["loss"] for h in single["history"]],
                     single["state"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(child.RING_STEP_CASES))
def test_ring_step_matches_jax(results, world, case):
    sync, _, method, optimizer = child.RING_STEP_CASES[case]
    losses, final = jax_steps(1 if sync else world, method, optimizer)
    ranks = results(world)
    assert_same_step(ranks[0]["step"][case], losses, final)
    for r in ranks[1:]:
        assert r["step"][case]["history"] == ranks[0]["step"][case]["history"]
        assert r["step"][case]["same_on_every_rank"]


# -- share splits --------------------------------------------------------------

SHARE_HINTS = (None, "", "garbage", "1:", ":0.5", "1:0", "1:-0.5", "1:1.5", "-1:0.5",
               "1:nan", "x:0.5", "1:0.5", "0:1.0", "0:0.5", "3:0.25", "2:0.01", "9:0.5",
               "bad", "1:1.0")


@pytest.mark.parametrize("hint", SHARE_HINTS)
def test_share_splits_match_jax(hint):
    assert parse_share_hint(hint) == jax_parse_hint(hint)
    for gbs, procs in ((64, 4), (96, 4), (96, 1), (8, 4), (16, 2), (7, 3)):
        assert share_splits(gbs, procs, hint) == jax_share_splits(gbs, procs, hint)


@pytest.mark.parametrize("hint", (None, "2:0.5", "0:0.25", "3:0.01"))
def test_share_hint_slices_union_is_the_global_batch(hint):
    images = np.arange(96)[:, None].astype(np.uint8)
    labels = np.arange(96).astype(np.int32)

    def slices(cls, share_hint):
        loaders = [cls(images, labels, 32, base_seed=11, process_index=p, process_count=4,
                       share_hint=share_hint) for p in range(4)]
        return [list(loader.epoch(3)) for loader in loaders]

    ours, theirs, uniform = slices(EpochLoader, hint), slices(JaxEpochLoader, hint), \
        slices(EpochLoader, None)
    for p in range(4):
        for (gi, gl), (ri, rl) in zip(ours[p], theirs[p]):
            assert gi.tobytes() == ri.tobytes() and gl.tobytes() == rl.tobytes()
    for step in range(3):
        union = np.concatenate([ours[p][step][1] for p in range(4)])
        np.testing.assert_array_equal(union, np.concatenate([uniform[p][step][1]
                                                             for p in range(4)]))


# -- the probe over processes -------------------------------------------------

@pytest.fixture(scope="module")
def probe_single(tmp_path_factory, results):
    """The probe driver in this process, with no group (after the spawns)."""
    results(2)
    patched = linear.load_dataset
    linear.load_dataset = child.probe_dataset
    try:
        with torch.random.fork_rng():
            return child.probe_run(str(tmp_path_factory.mktemp("probe1")))
    finally:
        linear.load_dataset = patched


def test_probe_over_two_processes_matches_one(results, probe_single):
    ranks = [r["probe"] for r in results(2)]
    assert probe_single["code"] == 0 and all(r["code"] == 0 for r in ranks)
    for got in ranks:
        for key, want in probe_single["classifier"].items():
            rel = ((got["classifier"][key] - want).norm() / want.norm()).item()
            assert rel <= PROBE_REL, (key, rel)
        assert [(v["top1"], v["top5"]) for v in got["val"]] == [
            (v["top1"], v["top5"]) for v in probe_single["val"]]
        assert got["best"] == probe_single["best"]
        np.testing.assert_allclose(got["losses"], probe_single["losses"], rtol=1e-5)


def test_probe_over_two_processes_writes_on_rank0_only(results):
    ranks = results(2)
    assert ranks[0]["writes"] == [CLASSIFIER_FILE]
    assert ranks[1]["writes"] == []
    assert ranks[0]["probe"]["path"] and ranks[1]["probe"]["path"] is None
    assert ranks[0]["probe"]["save_folder"] == ranks[1]["probe"]["save_folder"]
    with open(os.path.join(ranks[0]["probe"]["save_folder"], "log-ing")) as fh:
        assert "process 0 of 2" in fh.read()


def test_ring_banner_and_auto_never_ring():
    reason = supcon.resolve_loss_impl_reasoned("ring", torch.device("cpu"), 2)
    assert reason[0] == "ring" and "ring of 2 process(es)" in reason[1]
    for device in ("cpu", "cuda"):
        assert supcon.resolve_loss_impl_reasoned("auto", torch.device(device), 4)[0] != "ring"
