"""The port's child-process mechanics (``supervise/launch.py``,
``parallel/torchrun.py``) on the CPU.

- ``find_resume_dir`` on port run folders: the newest folder wins, as in
  the JAX package's scan on the same tree; ``classifier_*``/``ce_*`` are
  excluded by basename, even under a ``ce_`` workdir, and not excluded with
  ``exclude=()`` (``--all_run_dirs``); with ``require_checkpoint`` a folder
  counts only with a complete full-state ``.pth`` as
  ``utils/checkpoint.resolve_resume_path`` judges it (a torn file, a
  ``.pth.tmp``, a classifier file never count);
- ``topology_env`` replaces or adds ``PET_NPROC_PER_NODE`` and leaves every
  other variable alone, and torchrun's own parser reads it;
  ``share_env`` sets the hint and removes a stale one; ``build_command``
  appends ``--resume`` last;
- ``Child.terminate_gracefully``: a child that honours SIGTERM exits with
  its own code, one that absorbs it is killed after the grace window;
- the torchrun launcher's exit code is the first failed worker's.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch
from torch_threads import limit_threads

from simclr_pytorch_distributed_tpu.supervise import launch as jax_launch
from simclr_pytorch_distributed_tpu_torch.parallel import torchrun
from simclr_pytorch_distributed_tpu_torch.supervise import launch

limit_threads()

FAR = 4102444800
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def full_state(epoch=1):
    return {"model": {"w": torch.zeros(2)}, "epoch": epoch, "step": 4 * epoch,
            "step_in_epoch": 0}


def run_folder(ws, models, name, mtime, files=()):
    d = ws / models / name
    d.mkdir(parents=True)
    for fname, content in files:
        if content is None:
            torch.save(full_state(), d / fname)
        else:
            (d / fname).write_bytes(content)
    os.utime(d, (mtime, mtime))
    return d


@pytest.mark.parametrize("workdir", ["ws", "ce_experiments"])
def test_the_newest_pretrain_folder_wins_as_in_jax(tmp_path, workdir):
    ws = tmp_path / workdir
    assert launch.find_resume_dir(str(ws)) is None  # no workdir yet
    old = run_folder(ws, "cifar10_models", "cifar10_0101_0000_run", 1000,
                     [("ckpt_epoch_1.pth", None)])
    new = run_folder(ws, "synthetic_models", "synthetic_0102_0000_run", 2000)
    decoys = [run_folder(ws, "cifar10_models", name, FAR, [("last.pth", None)])
              for name in ("classifier_0103_0000_x", "ce_0103_0000_y")]
    assert launch.find_resume_dir(str(ws)) == str(new)
    assert launch.find_resume_dir(str(ws)) == jax_launch.find_resume_dir(str(ws))
    # a folder with nothing to resume from is skipped by the injection scan
    assert launch.find_resume_dir(str(ws), require_checkpoint=True) == str(old)
    # --all_run_dirs: the probe and CE folders are candidates
    assert launch.find_resume_dir(str(ws), exclude=()) in {str(d) for d in decoys}
    assert launch.find_resume_dir(str(ws), exclude=(), require_checkpoint=True) in {
        str(d) for d in decoys}


def test_only_a_complete_full_state_pth_counts(tmp_path):
    ws = tmp_path / "ws"
    run_folder(ws, "synthetic_models", "torn", 3000,
               [("last.pth", b"PK\x03\x04 torn"), ("ckpt_epoch_2.pth.tmp", b"x")])
    classifier_only = run_folder(ws, "synthetic_models", "weights_only", 2500, [])
    torch.save({"model": {"w": torch.zeros(2)}}, classifier_only / "classifier_best.pth")
    os.utime(classifier_only, (2500, 2500))
    good = run_folder(ws, "synthetic_models", "good", 1000, [("preempt_epoch_1_step_2.pth", None)])
    assert launch.find_resume_dir(str(ws)).endswith("torn")  # the watch channel: newest
    assert launch.find_resume_dir(str(ws), require_checkpoint=True) == str(good)
    os.remove(good / "preempt_epoch_1_step_2.pth")
    assert launch.find_resume_dir(str(ws), require_checkpoint=True) is None


def test_topology_env_sets_torchruns_process_count(monkeypatch):
    from torch.distributed.run import parse_args

    base = {launch.NPROC_ENV: "8", "XLA_FLAGS": "--foo=1", "OTHER": "x"}
    env = launch.topology_env(2, base)
    assert env == {launch.NPROC_ENV: "2", "XLA_FLAGS": "--foo=1", "OTHER": "x"}
    assert base[launch.NPROC_ENV] == "8"  # input not changed
    assert launch.topology_env(4, {"A": "b"}) == {"A": "b", launch.NPROC_ENV: "4"}
    assert launch.topology_env(None, {"A": "b"}) == {"A": "b"}
    # torchrun reads the variable when --nproc_per_node is absent, and a
    # flag on the command line still wins
    monkeypatch.setenv(launch.NPROC_ENV, launch.topology_env(3)[launch.NPROC_ENV])
    assert parse_args(["-m", "x"]).nproc_per_node == "3"
    assert parse_args(["--nproc_per_node", "2", "-m", "x"]).nproc_per_node == "2"


def test_share_env_sets_and_removes_the_hint():
    assert launch.FLEET_SHARE_ENV == jax_launch.FLEET_SHARE_ENV == "FLEET_SHARE_HINT"
    base = {launch.FLEET_SHARE_ENV: "0:0.25", "OTHER": "x"}
    assert launch.share_env("1:0.5", base) == {launch.FLEET_SHARE_ENV: "1:0.5", "OTHER": "x"}
    assert launch.share_env(None, base) == {"OTHER": "x"}  # a stale hint goes
    assert base[launch.FLEET_SHARE_ENV] == "0:0.25"
    env = launch.share_env("1:0.5", launch.topology_env(1, {"A": "b"}))
    assert env == {"A": "b", launch.NPROC_ENV: "1", launch.FLEET_SHARE_ENV: "1:0.5"}


def test_build_command_appends_resume_last():
    cmd = ["python", "-m", "x", "--resume", "stale"]
    got = launch.build_command(cmd, "/fresh")
    assert got == cmd + ["--resume", "/fresh"] == jax_launch.build_command(cmd, "/fresh")
    assert launch.build_command(["x"], None) == ["x"]


CHILD = """
import signal, sys, time
if sys.argv[1] == "honour":
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
else:
    signal.signal(signal.SIGTERM, lambda *a: None)
open(sys.argv[2], "w").close()
time.sleep(60)
"""


@pytest.mark.parametrize("mode, want", [("honour", 75), ("absorb", -signal.SIGKILL)])
def test_terminate_gracefully(tmp_path, mode, want):
    ready = tmp_path / "ready"
    child = launch.Child([sys.executable, "-c", CHILD, mode, str(ready)])
    deadline = time.monotonic() + 60
    while not ready.exists():  # the handler is installed
        assert time.monotonic() < deadline and child.poll() is None
        time.sleep(0.02)
    start = time.monotonic()
    assert child.terminate_gracefully(1.0, poll_s=0.02) == want
    took = time.monotonic() - start
    assert took < 1.0 if mode == "honour" else 1.0 <= took < 10


def test_the_torchrun_launcher_keeps_the_workers_code():
    assert [torchrun.shell_code(c) for c in (0, 75, 3, -9, -15)] == [0, 75, 3, 137, 143]
    script = "import sys, os; sys.exit(int(os.environ['RANK']) + 3)"
    out = subprocess.run(
        [sys.executable, "-m", "simclr_pytorch_distributed_tpu_torch.parallel.torchrun",
         "--standalone", "--nproc_per_node", "1", "--no-python", sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 3, out.stderr[-2000:]
