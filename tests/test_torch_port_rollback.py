"""The port's NaN rollback and elastic resume (``--nan_policy rollback``,
``--resume`` across world sizes), on the CPU.

The pretraining driver (``train.supcon.main``) runs here on a 64-image set
(rn10, 16 px, global batch 16: 4 steps an epoch) with no process group,
and in 2 gloo processes of ``tests/torch_parallel_child.py`` (suite
``resilience``), spawned once. A non-finite loss is injected at chosen
global steps through the driver's finite check, as the JAX package's
``tests/test_fault_injection.py:230-297`` injects it.

Rollback (JAX ``tests/test_fault_injection.py``, ``tests/test_guard.py:155-200``):
- ``FailurePolicy``: abort never rolls back; rollback damps by 0.5 and
  stops after 3; an unknown policy raises; its constants are the JAX
  package's, and it decides, counts and damps as the JAX policy does at
  every failure;
- the poisoned run's steps, final step, learning rates and checkpointed
  policy state are those of the JAX driver's rollback run (in this
  process, on the same data and schedule);
- a poisoned epoch 1 of 2: exit 0, ``crash_epoch_1.pth``, the step at
  ``steps_per_epoch`` after the skip, the learning rate 0.5 x the schedule
  from there on, ``last.pth`` holding ``lr_scale`` 0.5 and ``rollbacks`` 1,
  the generator past the skipped epoch's draws;
- a resume of that run keeps the damping;
- four injections exit 1 after three rollbacks;
- two identical rollback runs are bitwise equal;
- at P = 2 both processes roll back at the same step and end equal.

Elastic resume (``--syncBN --ngpu 2``, so the math does not depend on the
world size): a run SIGTERM'd after global step 2 under P = 1 resumes under
P = 2 and one SIGTERM'd under P = 2 resumes under P = 1; each ends within
the data-parallel driver pins (losses rtol 2e-5, final tensors relative L2
5e-2; ``tests/test_torch_port_parallel.py``) of the straight run, and the
resumed run's log names both world sizes. A checkpoint written without a
world size resumes, with no warning.
"""

import copy
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_child as child
from simclr_pytorch_distributed_tpu.utils import guard as jax_guard
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    AugmentConfig,
    sample_view_params,
    skip_view_draws,
)
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.utils.guard import (
    MAX_ROLLBACKS,
    ROLLBACK_LR_MULT,
    FailurePolicy,
)
from torch_threads import limit_threads

limit_threads()

WALL_LIMIT = 300
STEPS_PER_EPOCH = 4
LOSS_RTOL, DRIVER_REL_L2 = 2e-5, 5e-2  # tests/test_torch_port_parallel.py


def schedule(epochs):
    """The driver's cosine schedule for ``child.DRIVER_ARGV`` (lr 0.5)."""
    return make_lr_schedule(learning_rate=0.5, epochs=epochs, steps_per_epoch=STEPS_PER_EPOCH,
                            cosine=True)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def pth(folder, name):
    return os.path.join(folder, name)


def run(workdir, *extra, base=child.ROLLBACK_ARGV, poison=()):
    """The driver in this process, with a non-finite loss at ``poison``."""
    return child.run_summary(*child.poisoned(
        set(poison), lambda: child.driver_run(str(workdir), *extra, base=base)))


def _spawn(outdir, other_folder):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = child.REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, child.__file__, str(r), "2", str(outdir),
                               "resilience", other_folder], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=WALL_LIMIT)
            assert proc.returncode == 0, f"rank {r} of 2 exited {proc.returncode}:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver run of the module, once: here (P = 1) and in the two
    gloo processes (P = 2), in the order the resumes need."""
    patched = supcon.load_dataset
    supcon.load_dataset = child.tiny_dataset
    root = tmp_path_factory.mktemp("resilience")
    out = {}
    try:
        with torch.random.fork_rng():
            out["straight1"] = run(root / "straight1", base=child.ELASTIC_ARGV)
            # the preemption vote is taken at flush boundaries: one after step 2
            _, out["preempt1_losses"] = child.preempted_after(
                2, 0, 1, lambda: child.driver_run(str(root / "preempt1"), "--print_freq", "2",
                                                  base=child.ELASTIC_ARGV))
            out["preempt1"] = glob.glob(str(root / "preempt1" / "*_models" / "*"))[0]
            os.makedirs(root / "world2")
            out["ranks"] = _spawn(root / "world2", out["preempt1"])
            out["resumed1"] = run(root / "resumed1", "--resume", out["ranks"][0]["preempt"]["folder"],
                                  base=child.ELASTIC_ARGV)
            out["resumed1"]["log"] = open(pth(out["resumed1"]["save_folder"], "log-ing")).read()
            # a checkpoint from before the world size and rollback keys
            legacy = load(pth(out["preempt1"], "preempt_epoch_1_step_2.pth"))
            for key in ("world_size", "lr_scale", "rollbacks"):
                del legacy[key]
            os.makedirs(root / "legacy_ckpt")
            torch.save(legacy, root / "legacy_ckpt" / "preempt_epoch_1_step_2.pth")
            out["legacy"] = run(root / "legacy", "--resume", str(root / "legacy_ckpt"),
                                base=child.ELASTIC_ARGV)
            out["legacy"]["log"] = open(pth(out["legacy"]["save_folder"], "log-ing")).read()

            out["rollback"] = run(root / "rollback", poison={0})
            out["rollback_again"] = run(root / "rollback_again", poison={0})
            out["rollback_resumed"] = run(
                root / "rollback_resumed", "--epochs", "3", "--resume",
                out["rollback"]["save_folder"])
            out["four"] = run(root / "four", "--epochs", "4", poison={0, 4, 8, 12})
            out["four_folder"] = glob.glob(str(root / "four" / "*_models" / "*"))[0]
            out["abort"] = run(root / "abort", "--nan_policy", "abort", poison={0})
            out["jax_rollback"] = jax_rollback_run(root / "jax_rollback")
    finally:
        supcon.load_dataset = patched
    return out


def jax_rollback_run(workdir):
    """The JAX package's driver (in this process, one device) on the port's
    rollback run: rn10 at 16 px, batch 16 on :func:`child.tiny_dataset`'s
    64 images (4 steps an epoch), 2 epochs, lr 0.5 cosine, a non-finite
    loss at global step 0, as ``tests/test_fault_injection.py`` injects it.
    Returns the global steps its finite check saw, the schedules it built
    its update with (the damped one after a rollback), its final step and
    the policy state in its last checkpoint's meta."""
    import json

    import jax

    from simclr_pytorch_distributed_tpu import config as jax_config
    from simclr_pytorch_distributed_tpu.data import cifar as jax_cifar
    from simclr_pytorch_distributed_tpu.parallel import mesh as jax_mesh
    from simclr_pytorch_distributed_tpu.train import supcon as jax_supcon

    steps, schedules = [], []
    check, fused_update = jax_supcon.check_finite_loss, jax_supcon.make_fused_update

    def poisoned_check(loss, step, enabled=True):
        steps.append(int(step))
        if int(step) == 0:
            raise jax_guard.NonFiniteLossError(float("nan"), int(step))
        return check(loss, step, enabled)

    def recording_update(model, tx, sched, *args, **kwargs):
        schedules.append(sched)
        return fused_update(model, tx, sched, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cifar, "synthetic_dataset",
                   lambda *a, **k: child.tiny_dataset(None, None)[:2])
        mp.setattr(jax_supcon, "create_mesh",
                   lambda devices=None, **kw: jax_mesh.create_mesh(
                       devices=jax.devices()[:1] if devices is None else devices, **kw))
        mp.setattr(jax_supcon, "check_finite_loss", poisoned_check)
        mp.setattr(jax_supcon, "make_fused_update", recording_update)
        cfg = jax_config.finalize_supcon(jax_config.SupConConfig(
            model="resnet10", dataset="synthetic", batch_size=16, epochs=2,
            learning_rate=0.5, temp=0.5, cosine=True, save_freq=100, print_freq=1,
            size=16, feat_dim=16, syncBN=True, workdir=str(workdir), seed=3,
            method="SimCLR", trial="rb", nan_policy="rollback"))
        state = jax_supcon.run(cfg)
    with open(os.path.join(cfg.save_folder, "last", "meta.json")) as fh:
        meta = json.load(fh)
    return {"steps": steps, "schedules": schedules, "step": int(state.step),
            "meta": meta, "crash": os.path.isdir(pth(cfg.save_folder, "crash_epoch_1"))}


# -- the policy ---------------------------------------------------------------

def test_failure_policy_abort_never_rolls_back():
    p = FailurePolicy("abort")
    assert not p.should_rollback()
    assert p.lr_scale == 1.0 and p.rollbacks == 0


def test_failure_policy_rollback_damps_lr_and_caps():
    p = FailurePolicy("rollback")
    grants = [p.should_rollback() for _ in range(MAX_ROLLBACKS + 2)]
    assert grants == [True] * MAX_ROLLBACKS + [False, False]
    assert p.rollbacks == MAX_ROLLBACKS
    np.testing.assert_allclose(p.lr_scale, ROLLBACK_LR_MULT ** MAX_ROLLBACKS)


def test_failure_policy_constants_are_the_jax_packages():
    assert (MAX_ROLLBACKS, ROLLBACK_LR_MULT) == (jax_guard.MAX_ROLLBACKS,
                                                 jax_guard.ROLLBACK_LR_MULT)


@pytest.mark.parametrize("policy", ["abort", "rollback"])
def test_failure_policy_steps_like_the_jax_policy(policy):
    """Each failure, the port's policy and the JAX package's decide alike
    and carry the same count and damping, past the budget's end."""
    ours, theirs = FailurePolicy(policy), jax_guard.FailurePolicy(policy)
    for _ in range(jax_guard.MAX_ROLLBACKS + 2):
        assert ours.should_rollback() == theirs.should_rollback()
        assert (ours.rollbacks, ours.lr_scale) == (theirs.rollbacks, theirs.lr_scale)


def test_failure_policy_rejects_unknown():
    with pytest.raises(ValueError, match="nan_policy"):
        FailurePolicy("retry")


def test_skip_view_draws_matches_the_steps_draws():
    cfg = AugmentConfig(size=8)
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for _ in range(3):
        sample_view_params(a, 2 * 16, 32, 32, cfg)
    skip_view_draws(b, 3, 16, 32, 32, cfg)
    assert torch.equal(a.get_state(), b.get_state())


# -- rollback -------------------------------------------------------------------

def test_rollback_completes_the_run(runs):
    r = runs["rollback"]
    assert r["code"] == 0
    # the poisoned step, then epoch 2 from the step after the skipped epoch
    assert r["steps"] == [0] + list(range(STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH))
    assert r["step"] == 2 * STEPS_PER_EPOCH
    assert os.path.isfile(pth(r["save_folder"], "crash_epoch_1.pth"))
    crash = load(pth(r["save_folder"], "crash_epoch_1.pth"))
    assert (crash["epoch"], crash["step"], crash["step_in_epoch"]) == (0, 0, 0)
    assert (crash["lr_scale"], crash["rollbacks"]) == (1.0, 0)


def test_rollback_halves_the_schedule(runs):
    r = runs["rollback"]
    sched = schedule(2)
    # the history holds each step's rate as a float32 tensor's value
    np.testing.assert_allclose(r["lrs"], [sched(0)] + [0.5 * sched(s) for s in r["steps"][1:]],
                               rtol=1e-6)


def test_rollback_follows_the_jax_driver(runs):
    """The poisoned run's steps, final step, learning rates and policy
    state against the JAX driver's rollback run on the same schedule: the
    rate of the poisoned step from its undamped schedule, every later
    rate from the damped one."""
    ours, theirs = runs["rollback"], runs["jax_rollback"]
    assert theirs["steps"] == ours["steps"] and theirs["step"] == ours["step"]
    assert theirs["crash"] and len(theirs["schedules"]) == 2
    undamped, damped = theirs["schedules"]
    want = [float(undamped(0))] + [float(damped(s)) for s in ours["steps"][1:]]
    np.testing.assert_allclose(ours["lrs"], want, rtol=1e-6)
    last = load(pth(ours["save_folder"], "last.pth"))
    assert (last["lr_scale"], last["rollbacks"]) == (theirs["meta"]["lr_scale"],
                                                     theirs["meta"]["rollbacks"])


def test_rollback_state_rides_last_pth(runs):
    last = load(pth(runs["rollback"]["save_folder"], "last.pth"))
    assert last["lr_scale"] == 0.5 and last["rollbacks"] == 1
    assert last["step"] == 2 * STEPS_PER_EPOCH and last["world_size"] == 1


def test_rollback_generator_skips_the_epochs_draws(runs):
    """After the skip the generator is where the run that took epoch 1
    would have left it: both runs end with the same generator state."""
    rolled = load(pth(runs["rollback"]["save_folder"], "last.pth"))["generator"]
    straight = load(pth(runs["straight1"]["save_folder"], "last.pth"))["generator"]
    assert torch.equal(rolled, straight)


def test_rollback_resume_keeps_the_damping(runs):
    r = runs["rollback_resumed"]
    assert r["code"] == 0 and r["step"] == 3 * STEPS_PER_EPOCH
    sched = schedule(3)
    np.testing.assert_allclose(r["lrs"], [0.5 * sched(s) for s in r["steps"]], rtol=1e-6)
    last = load(pth(r["save_folder"], "last.pth"))
    assert last["lr_scale"] == 0.5 and last["rollbacks"] == 1


def test_four_failures_exit_1_after_three_rollbacks(runs):
    assert runs["four"]["code"] == 1
    folder = runs["four_folder"]
    crashes = sorted(os.path.basename(p) for p in glob.glob(pth(folder, "crash_epoch_*.pth")))
    assert crashes == [f"crash_epoch_{e}.pth" for e in (1, 2, 3, 4)]
    last_crash = load(pth(folder, "crash_epoch_4.pth"))
    assert last_crash["rollbacks"] == 3 and last_crash["lr_scale"] == 0.125
    assert not os.path.isfile(pth(folder, "last.pth"))


def test_abort_policy_exits_1(runs):
    assert runs["abort"]["code"] == 1


def test_two_rollback_runs_are_bitwise_equal(runs):
    a, b = runs["rollback"], runs["rollback_again"]
    assert a["losses"][1:] == b["losses"][1:] and a["lrs"] == b["lrs"]
    for key, value in a["state"].items():
        assert torch.equal(b["state"][key], value), key


def test_rollback_at_two_processes(runs):
    ranks = [r["rollback"] for r in runs["ranks"]]
    assert [r["code"] for r in ranks] == [0, 0]
    assert ranks[0]["steps"] == ranks[1]["steps"] == runs["rollback"]["steps"]
    assert ranks[0]["losses"][1:] == ranks[1]["losses"][1:]
    for key, value in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][key], value), key
    assert ranks[0]["lrs"] == runs["rollback"]["lrs"]


# -- elastic resume ------------------------------------------------------------

def assert_driver_pins(got, want):
    assert got["code"] == 0 and got["step"] == want["step"] == 2 * STEPS_PER_EPOCH
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for key, ref in want["state"].items():
        if ref.is_floating_point():
            rel = ((got["state"][key] - ref).norm() / ref.norm()).item()
            assert rel <= DRIVER_REL_L2, (key, rel)


def test_straight_runs_agree_across_world_sizes(runs):
    assert_driver_pins(runs["ranks"][0]["straight"], runs["straight1"])


def test_resume_from_one_process_under_two(runs):
    for r in runs["ranks"]:
        got = copy.deepcopy(r["resumed"])
        got["losses"] = runs["preempt1_losses"] + got["losses"]
        assert_driver_pins(got, r["straight"])
    log = runs["ranks"][0]["resumed"]["log"]
    assert "elastic resume" in log and "saved under 1 process(es), restoring under 2" in log
    assert "--syncBN off" in log and "--ngpu" in log


def test_resume_from_two_processes_under_one(runs):
    got = copy.deepcopy(runs["resumed1"])
    got["losses"] = runs["ranks"][0]["preempt"]["losses"] + got["losses"]
    assert_driver_pins(got, runs["straight1"])
    assert "saved under 2 process(es), restoring under 1" in got["log"]


def test_preempted_runs_exit_75_on_every_process(runs):
    assert [r["preempt"]["code"] for r in runs["ranks"]] == [75, 75]
    saved = load(pth(runs["ranks"][0]["preempt"]["folder"], "preempt_epoch_1_step_2.pth"))
    assert saved["world_size"] == 2 and saved["step"] == 2


def test_checkpoint_without_world_size_resumes(runs):
    got = copy.deepcopy(runs["legacy"])
    got["losses"] = runs["preempt1_losses"] + got["losses"]
    assert got["code"] == 0
    assert got["losses"] == runs["straight1"]["losses"]
    for key, value in runs["straight1"]["state"].items():
        assert torch.equal(got["state"][key], value), key
    assert "elastic resume" not in got["log"]
