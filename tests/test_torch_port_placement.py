"""``--data_placement`` through the port's three trainers, on the CPU at a
tiny size (rn10, 64 training images, batch 8 or 16), and the data flags.

- pretraining (``train.supcon.main``), the probe (``train.linear.main``)
  and the CE trainer (``train.ce.main``) under ``device`` and ``window``
  (windows of 3: a padded tail) give a ``history`` bitwise equal to
  ``host``, every column but ``step_time``, and the same final tensors;
- a pretraining run preempted mid-window (exit 75) and resumed under
  ``window`` ends bitwise equal to the straight ``host`` run;
- an explicit ``device`` over its budget raises before step 1, with the
  exit code stamped on the recorder, and a resolved placement banners;
- the three parsers take the data flags as the JAX package's do; ``path``
  with ``device`` is refused at parse time and needs ``--mean/--std``;
  the probe and CE parsers have no ``path``; ``--dataset path`` trains
  from an image tree with the user's normalization.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from simclr_pytorch_distributed_tpu import config as jax_config
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.train import ce, linear, supcon
from simclr_pytorch_distributed_tpu_torch.train.supcon_step import train_step
from simclr_pytorch_distributed_tpu_torch.utils import preempt
from torch_threads import limit_threads

limit_threads()

PLACEMENTS = {"host": [], "device": [],
              "window": ["--data_window_batches", "3"]}
SUPCON_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
    "--batch_size", "8", "--learning_rate", "0.5", "--temp", "0.5", "--print_freq", "3",
    "--feat_dim", "16", "--loss_impl", "fused", "--epochs", "2", "--save_freq", "5",
]
LINEAR_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--batch_size", "16",
    "--epochs", "1", "--learning_rate", "1", "--val_batch_size", "10", "--print_freq", "3",
]
CE_ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--batch_size", "16",
    "--epochs", "1", "--learning_rate", "0.05", "--val_batch_size", "8", "--print_freq", "3",
]


def tiny_dataset(dataset, data_folder):
    """64 train and 16 test images of 4 classes, 16 px."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 80).astype(np.int32)
    means = rng.uniform(40, 216, (4, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 24, (80, 16, 16, 3)), 0, 255)
    images = images.astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 4)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    for module in (supcon, linear, ce):
        monkeypatch.setattr(module, "load_dataset", tiny_dataset)


def _placement(name):
    return ["--data_placement", name] + PLACEMENTS[name]


def same_history(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            if k != "step_time" and not (x[k] == y[k] or (math.isnan(x[k]) and math.isnan(y[k]))):
                return False
    return True


def assert_same_tensors(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """Two pretraining epochs under each placement (8 steps an epoch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", tiny_dataset)
        return {name: supcon.main(SUPCON_ARGV + _placement(name) + [
            "--workdir", str(tmp_path_factory.mktemp(name))]) for name in PLACEMENTS}


@pytest.mark.parametrize("placement", ["device", "window"])
def test_pretraining_equals_host(pretrain_runs, placement):
    got, want = pretrain_runs[placement], pretrain_runs["host"]
    assert len(want.history) == 16 and same_history(got.history, want.history)
    assert_same_tensors(got.state.model.state_dict(), want.state.model.state_dict())
    assert torch.equal(got.state.record_norm_mean, want.state.record_norm_mean)
    with open(os.path.join(got.save_folder, "log-ing")) as fh:
        log = fh.read()
    assert f"data_placement: {placement} (" in log
    # DT is logged under a store too
    assert "\tDT " in log


@pytest.mark.parametrize("placement", ["device", "window"])
def test_probe_equals_host(placement, tmp_path):
    runs = {name: linear.main(LINEAR_ARGV + _placement(name) + ["--workdir", str(tmp_path / name)])
            for name in ("host", placement)}
    got, want = runs[placement], runs["host"]
    assert len(want.history) == 4 and same_history(got.history, want.history)
    assert got.val_history[0]["top1"] == want.val_history[0]["top1"]
    assert_same_tensors(got.state.model.state_dict(), want.state.model.state_dict())


@pytest.mark.parametrize("placement", ["device", "window"])
def test_ce_equals_host(placement, tmp_path):
    runs = {name: ce.main(CE_ARGV + _placement(name) + ["--workdir", str(tmp_path / name)])
            for name in ("host", placement)}
    got, want = runs[placement], runs["host"]
    assert len(want.history) == 4 and same_history(got.history, want.history)
    assert (got.best_acc, got.best_acc5) == (want.best_acc, want.best_acc5)
    assert_same_tensors(got.state.model.state_dict(), want.state.model.state_dict())


def test_window_resume_mid_window_is_the_straight_run(pretrain_runs, tmp_path, monkeypatch):
    losses = []

    def step(state, cfg, views, labels):
        metrics = train_step(state, cfg, views, labels)
        losses.append(metrics["loss"].item())
        if state.step == 5:  # after step index 4: window 1, offset 1
            preempt.request()
        return metrics

    monkeypatch.setattr(supcon, "train_step", step)
    with pytest.raises(SystemExit) as exc:
        # the preemption vote is taken at flush boundaries: one after step 5
        supcon.main(SUPCON_ARGV + _placement("window") + ["--workdir", str(tmp_path / "a"),
                                                          "--print_freq", "5"])
    assert exc.value.code == 75
    saved = glob.glob(str(tmp_path / "a" / "*" / "*" / "preempt_epoch_1_step_5.pth"))
    assert len(saved) == 1
    monkeypatch.setattr(supcon, "train_step", train_step)
    resumed = supcon.main(SUPCON_ARGV + _placement("window") + [
        "--workdir", str(tmp_path / "b"), "--resume", os.path.dirname(saved[0])])
    straight = pretrain_runs["host"]
    assert losses + [h["loss"] for h in resumed.history] == [h["loss"] for h in straight.history]
    assert resumed.state.step == straight.state.step == 16
    assert_same_tensors(resumed.state.model.state_dict(), straight.state.model.state_dict())


def test_explicit_placement_over_budget_raises_before_step_1(tmp_path):
    argv = SUPCON_ARGV + ["--dataset", "synthetic", "--size", "32", "--data_placement", "device",
                          "--device_budget_mb", "1", "--workdir", str(tmp_path)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", _synthetic)  # 5.5 MB of images
        with pytest.raises(ValueError, match="cannot be satisfied: dataset needs"):
            supcon.main(argv)
    (run,) = glob.glob(str(tmp_path / "*" / "*"))
    with open(os.path.join(run, "log-ing")) as fh:
        assert "Train:" not in fh.read()
    with open(os.path.join(run, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    assert [e["args"]["code"] for e in events if e["name"] == "run_exit"] == [1]
    assert [e["args"]["kind"] for e in events if e["name"] == "clock_anchor"] == ["placement"]


def _synthetic(dataset, data_folder):
    from simclr_pytorch_distributed_tpu_torch.data.cifar import synthetic_dataset
    return (*synthetic_dataset(), 10)


DATA_FLAGS = ["--data_placement", "window", "--data_window_batches", "5",
              "--device_budget_mb", "64", "--no_download"]


@pytest.mark.parametrize("trainer", ["supcon", "linear", "ce"])
def test_parsers_take_the_data_flags_as_jax(trainer):
    ours = {"supcon": config_lib.supcon_parser, "linear": config_lib.linear_parser,
            "ce": lambda: config_lib.linear_parser(ce=True)}[trainer]().parse_args(DATA_FLAGS)
    theirs = {"supcon": jax_config.supcon_parser, "linear": jax_config.linear_parser,
              "ce": lambda: jax_config.linear_parser(ce=True)}[trainer]().parse_args(DATA_FLAGS)
    for key in ("data_placement", "data_window_batches", "device_budget_mb", "download"):
        assert getattr(ours, key) == getattr(theirs, key), key
    defaults = {"supcon": config_lib.supcon_parser, "linear": config_lib.linear_parser,
                "ce": lambda: config_lib.linear_parser(ce=True)}[trainer]().parse_args([])
    assert (defaults.data_placement, defaults.data_window_batches, defaults.device_budget_mb,
            defaults.download) == ("auto", 32, 0, True)


def test_path_flags_and_refusals(tmp_path):
    with pytest.raises(SystemExit):  # the budget and the window are positive
        config_lib.supcon_parser().parse_args(["--device_budget_mb", "0"])
    path = ["--dataset", "path", "--data_folder", str(tmp_path), "--mean", "(0.4,0.5,0.6)",
            "--std", "(0.2,0.2,0.2)", "--store_size", "24", "--mmap_threshold_mb", "7",
            "--workdir", str(tmp_path)]
    cfg = config_lib.parse_supcon(path)
    assert (cfg.store_size, cfg.mmap_threshold_mb) == (24, 7)
    aug = supcon.make_augment_config(cfg)
    assert aug.mean == (0.4, 0.5, 0.6) and aug.std == (0.2, 0.2, 0.2)
    with pytest.raises(ValueError, match="not accepted with --dataset path"):
        config_lib.parse_supcon(path + ["--data_placement", "device"])
    with pytest.raises(ValueError, match="--mean and --std"):
        config_lib.parse_supcon(["--dataset", "path", "--data_folder", str(tmp_path)])
    assert config_lib.parse_supcon(["--workdir", str(tmp_path)]).data_folder == "./datasets/"
    for ce_parser in (False, True):
        with pytest.raises(SystemExit):
            config_lib.linear_parser(ce=ce_parser).parse_args(["--dataset", "path"])


def test_path_dataset_trains_from_a_tree(tmp_path, monkeypatch):
    monkeypatch.undo()  # the real load_dataset
    rng = np.random.default_rng(2)
    for cls in ("a", "b"):
        (tmp_path / "tree" / cls).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(
                tmp_path / "tree" / cls / f"{i}.png")
    result = supcon.main([
        "--device", "cpu", "--dataset", "path", "--data_folder", str(tmp_path / "tree"),
        "--mean", "(0.5,0.5,0.5)", "--std", "(0.25,0.25,0.25)", "--model", "resnet10",
        "--size", "8", "--batch_size", "8", "--epochs", "1", "--print_freq", "1",
        "--feat_dim", "16", "--data_placement", "window", "--data_window_batches", "1",
        "--workdir", str(tmp_path / "work")])
    assert len(result.history) == 2 and all(math.isfinite(h["loss"]) for h in result.history)
