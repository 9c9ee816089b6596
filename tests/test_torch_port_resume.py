"""Warm start, full-state resume and the exit codes of the port's pretrain
driver, on the CPU at a tiny size (rn10, 8 px, batch 8, a 64-image set of
8 steps an epoch).

A resumed run must be the run that did not stop, bit for bit: every
parameter, BN buffer and SGD momentum buffer, the step, ``record_norm_mean``
and every step's loss. That holds after a finished epoch and ``--resume``,
and after a preemption (``preempt.request()`` from inside a step, as the
SIGTERM handler would set the flag) mid-epoch or in an epoch's last step.
A non-finite loss exits 1 with ``crash_epoch_N.pth`` holding the epoch-top
state; ``--ckpt`` loads weights and BN buffers only. ``resume_position``
and ``exit_code_for`` agree with the JAX package's functions.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.utils import guard as jguard
from simclr_pytorch_distributed_tpu.utils.checkpoint import (
    resume_position as jax_resume_position,
)
from simclr_pytorch_distributed_tpu.utils.torch_convert import convert_reference_checkpoint
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.train import supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
from simclr_pytorch_distributed_tpu_torch.utils import guard, preempt
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
    load_model_state,
    resolve_resume_path,
    resume_position,
)
from torch_threads import limit_threads

limit_threads()

STEPS = 8  # 64 images / batch 8
ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
    "--batch_size", "8", "--learning_rate", "0.5", "--temp", "0.5", "--print_freq", "100",
    "--feat_dim", "16", "--loss_impl", "fused", "--norm_momentum", "0.5",
]


def tiny_dataset(dataset, data_folder):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 80).astype(np.int32)
    means = rng.uniform(48, 208, (10, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 32, (80, 8, 8, 3)), 0, 255).astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 10)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(supcon, "load_dataset", tiny_dataset)


def pretrain(workdir, *extra):
    return supcon.main(ARGV + ["--workdir", str(workdir), *extra])


def record_steps(monkeypatch, stop_after=None, nan_at=None):
    """Wrap the driver's train step: record each step's loss, request a
    preemption after global step ``stop_after`` and report a NaN loss at
    global step ``nan_at``."""
    losses = []
    def step(state, cfg, views, labels):
        metrics = train_step(state, cfg, views, labels)
        if state.step - 1 == nan_at:
            metrics["loss"] = torch.tensor(float("nan"))
        losses.append(metrics["loss"].item())
        if state.step - 1 == stop_after:
            preempt.request()
        return metrics

    monkeypatch.setattr(supcon, "train_step", step)
    return losses


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Two epochs that do not stop."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", tiny_dataset)
        return pretrain(tmp_path_factory.mktemp("straight"), "--epochs", "2", "--save_freq", "1")


def assert_same_run(result, losses, ref):
    assert losses == [h["loss"] for h in ref.history]
    assert result.state.step == ref.state.step == 2 * STEPS
    assert torch.equal(result.state.record_norm_mean, ref.state.record_norm_mean)
    got, want = result.state.model.state_dict(), ref.state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    got_opt = result.state.optimizer.state_dict()["state"]
    want_opt = ref.state.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        assert torch.equal(got_opt[k]["momentum_buffer"], want_opt[k]["momentum_buffer"]), k


def test_resume_after_an_epoch_is_the_straight_run(straight, tmp_path):
    first = pretrain(tmp_path / "a", "--epochs", "1")
    resumed = pretrain(tmp_path / "b", "--epochs", "2", "--resume", first.save_folder)
    losses = [h["loss"] for h in first.history + resumed.history]
    assert [h["step"] for h in resumed.history] == list(range(STEPS, 2 * STEPS))
    assert_same_run(resumed, losses, straight)
    log = open(os.path.join(resumed.save_folder, "log-ing")).read()
    assert f"resumed from {os.path.join(first.save_folder, 'last.pth')} at epoch 2 step 0" in log


@pytest.mark.parametrize("stop_after, save_freq, expect_file", [
    (2, 1, "preempt_epoch_1_step_3.pth"),  # mid-epoch
    (STEPS - 1, 1, "ckpt_epoch_1.pth"),  # the last step: the scheduled save covers it
    (STEPS - 1, 5, "preempt_epoch_1.pth"),  # the last step, no scheduled save
])
def test_preempted_run_exits_75_and_resumes_bitwise(
    straight, tmp_path, monkeypatch, stop_after, save_freq, expect_file
):
    losses = record_steps(monkeypatch, stop_after=stop_after)
    with pytest.raises(SystemExit) as exc:
        # the preemption vote is taken at flush boundaries: one after step 3
        pretrain(tmp_path / "a", "--epochs", "2", "--save_freq", str(save_freq),
                 "--print_freq", "3")
    assert exc.value.code == preempt.EXIT_PREEMPTED == 75
    assert guard.exit_code_for(exc.value) == 75
    assert len(losses) == stop_after + 1
    saved = glob.glob(str(tmp_path / "a" / "*" / "*" / "*.pth"))
    assert [os.path.basename(p) for p in saved] == [expect_file]
    assert not preempt.requested()  # the driver uninstalled its handlers
    monkeypatch.setattr(supcon, "train_step", train_step)
    resumed = pretrain(tmp_path / "b", "--epochs", "2", "--save_freq", str(save_freq),
                       "--resume", os.path.dirname(saved[0]))
    assert_same_run(resumed, losses + [h["loss"] for h in resumed.history], straight)


def test_warm_start_loads_weights_and_bn_buffers_only(straight, tmp_path, monkeypatch):
    seen = {}

    def step(state, cfg, views, labels):
        if not seen:
            seen.update(step=state.step, opt=dict(state.optimizer.state),
                        record=state.record_norm_mean,
                        model={k: v.clone() for k, v in state.model.state_dict().items()})
        return train_step(state, cfg, views, labels)

    monkeypatch.setattr(supcon, "train_step", step)
    ckpt = os.path.join(straight.save_folder, "last.pth")
    pretrain(tmp_path, "--epochs", "1", "--ckpt", ckpt)
    assert seen["step"] == 0 and seen["opt"] == {} and seen["record"] is None
    want = straight.state.model.state_dict()
    for k, v in seen["model"].items():
        assert torch.equal(v, want[k]), k


def init_model_state():
    torch.manual_seed(0)
    return SupConResNet("resnet10", "mlp", 16).state_dict()


@pytest.mark.parametrize("how", ["lr_inf", "nan_in_epoch_2"])
def test_non_finite_loss_exits_1_with_the_epoch_top_saved(straight, tmp_path, monkeypatch, how):
    if how == "lr_inf":
        # step 0's loss is finite; its update of inf leaves step 1 NaN
        extra, epoch, top = ("--learning_rate", "inf"), 1, init_model_state()
    else:
        record_steps(monkeypatch, nan_at=STEPS + 2)
        extra, epoch = (), 2
        top = load_model_state(os.path.join(straight.save_folder, "ckpt_epoch_1.pth"))
    with pytest.raises(SystemExit) as exc:
        pretrain(tmp_path, "--epochs", "2", "--save_freq", "1", *extra)
    assert exc.value.code == guard.EXIT_NONFINITE == 1
    assert isinstance(exc.value.__cause__, guard.NonFiniteLossError)
    (path,) = glob.glob(str(tmp_path / "*" / "*" / f"crash_epoch_{epoch}.pth"))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"], ckpt["step_in_epoch"]) == (
        epoch - 1, (epoch - 1) * STEPS, 0)
    for k, v in top.items():
        assert torch.equal(ckpt["model"][f"module.{k}"], v), k


def test_nan_guard_off_trains_on(tmp_path):
    result = pretrain(tmp_path, "--epochs", "1", "--learning_rate", "inf", "--nan_guard", "off")
    assert len(result.history) == STEPS and math.isnan(result.history[-1]["loss"])


def test_full_state_checkpoint_keeps_the_reference_layout(straight, tmp_path):
    path = os.path.join(straight.save_folder, "last.pth")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert {"opt", "model", "optimizer", "epoch"} <= set(ckpt)
    assert (ckpt["epoch"], ckpt["step"], ckpt["step_in_epoch"], ckpt["seed"]) == (
        2, 2 * STEPS, 0, 0)
    assert ckpt["generator_device"] == "cpu" and ckpt["generator"].dtype == torch.uint8
    info = convert_reference_checkpoint(path, str(tmp_path / "converted"))
    assert (info["model_name"], info["head"], info["feat_dim"], info["epoch"]) == (
        "resnet10", "mlp", 16, 2)


def test_resolve_resume_path_takes_the_most_progress(straight, tmp_path):
    src = os.path.join(straight.save_folder, "ckpt_epoch_1.pth")
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    for name, epoch, k in (("ckpt_epoch_1.pth", 1, 0), ("preempt_epoch_2_step_3.pth", 1, 3),
                           ("crash_epoch_2.pth", 1, 3), ("last.pth", 0, 0)):
        torch.save(dict(ckpt, epoch=epoch, step_in_epoch=k), tmp_path / name)
    (tmp_path / "ckpt_epoch_9.pth").write_bytes(b"torn")
    torch.save({"model": {}}, tmp_path / "classifier_best.pth")
    assert resolve_resume_path(str(tmp_path)) == str(tmp_path / "preempt_epoch_2_step_3.pth")
    os.remove(tmp_path / "preempt_epoch_2_step_3.pth")
    assert resolve_resume_path(str(tmp_path)) == str(tmp_path / "crash_epoch_2.pth")
    assert resolve_resume_path(src) == src
    with pytest.raises(FileNotFoundError):
        resolve_resume_path(str(tmp_path / "nothing"))


def test_resume_of_a_weights_only_file_raises(straight, tmp_path):
    path = tmp_path / "weights.pth"
    torch.save({"model": straight.state.model.state_dict(), "epoch": 2}, path)
    with pytest.raises(ValueError, match="no full training state"):
        pretrain(tmp_path, "--epochs", "3", "--resume", str(path))


@pytest.mark.parametrize("meta, steps", [
    ({"epoch": 3, "step_in_epoch": 7}, 10), ({"epoch": 3}, 10), ({}, 10),
    ({"epoch": 3, "step_in_epoch": 10}, 10), ({"epoch": 3, "step_in_epoch": 12}, 10),
    ({"epoch": 3, "step_in_epoch": "abc"}, 10), ({"epoch": 3, "step_in_epoch": None}, 10),
    ({"epoch": 0, "step_in_epoch": 3}, 8),
])
def test_resume_position_matches_jax(meta, steps):
    assert resume_position(meta, steps) == jax_resume_position(meta, steps)


@pytest.mark.parametrize("exc", [
    None, SystemExit(75), SystemExit(None), SystemExit(2), RuntimeError("boom"),
], ids=["none", "exit75", "exit_none", "exit2", "plain"])
def test_exit_code_for_matches_jax(exc):
    assert guard.exit_code_for(exc) == jguard.exit_code_for(exc)


def test_exit_code_for_non_finite_matches_jax():
    port = guard.exit_code_for(guard.NonFiniteLossError(float("nan"), 3))
    assert port == jguard.exit_code_for(jguard.NonFiniteLossError(float("nan"), 3)) == 1
