"""``scripts/port_supervisor_matrix.py`` and the fleet launcher's trainer
mode on the CPU.

- The matrix's ``collapse`` scenario end to end at rn10, 8 px (64 synthetic
  images, batch 16): the port's supervisor over the port's trainer, exit 3
  after an observed ``health_alarm``, ``give_up``; its one-scenario
  artifact, judged by the ``supervisor_gate`` record, fails on the first
  missing scenario. (Resize and the straggler ladder run on the CPU in
  ``tests/test_torch_port_supervise_run.py``.)
- ``scripts/port_fleet_launcher.py --trainer``: the layout (NCCL with one
  process a card where the cards suffice, else gloo with
  ``--dist_backend gloo`` and the cards in turn; gloo on the CPU), each
  process's torchrun environment and argv (the sidecar on process 0, the
  forwarded ``--resume``), the process count from ``PET_NPROC_PER_NODE``,
  and the flags after ``--`` refused without ``--trainer``.
- The matrix's bookkeeping: the launches summed over each process's last
  report, the supervisor's spans read as recovery times.
"""

import importlib.util
import json
import os
import sys

import pytest
from torch_threads import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


matrix = _script("port_supervisor_matrix")
launcher = _script("port_fleet_launcher")
port_ratchet = _script("port_ratchet")

CPU_GEOMETRY = ["--device", "cpu", "--model", "resnet10", "--size", "8", "--batch_size", "16",
                "--images", "64", "--feat_dim", "16", "--learning_rate", "0.05", "--no-bf16"]


@pytest.fixture
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.delenv("PET_NPROC_PER_NODE", raising=False)


def test_the_collapse_scenario_end_to_end_on_the_cpu(tmp_path, one_thread_children, capsys):
    out = tmp_path / "sup.json"
    code = matrix.main(CPU_GEOMETRY + ["--scenarios", "collapse", "--workdir",
                                       str(tmp_path / "wd"), "--json", str(out)])
    assert code == 0
    artifact = json.loads(out.read_text())
    rec = artifact["scenarios"]["collapse"]
    assert rec["ok"] and rec["rc"] == 3 and rec["decisions"] == ["give_up"]
    assert rec["health_alarms_observed"] >= 1 and rec["attempts"] == 1
    assert artifact["device"] == "cpu" and artifact["card"] is None
    assert artifact["trainer"]["conv_impl"] == "auto"
    record = port_ratchet.supervisor_gate_record(artifact)
    assert not record["ok"] and record["error"] == (
        "scenario 'sigkill' missing from the matrix artifact")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[-1]["metric"] == "port_supervisor_matrix" and lines[-1]["ok"]


class _Cards:
    def __init__(self, n):
        self.n = n

    def __call__(self):
        return self.n


@pytest.mark.parametrize("cards,nproc,want", [
    (4, 2, ("nccl", 4, [])),
    (2, 2, ("nccl", 2, [])),
    (1, 2, ("gloo", 1, ["--dist_backend", "gloo"])),
    (2, 4, ("gloo", 2, ["--dist_backend", "gloo"])),
])
def test_the_trainer_layout_follows_the_card_count(monkeypatch, cards, nproc, want):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", _Cards(cards))
    assert launcher.trainer_layout(["--model", "resnet18"], nproc) == want
    assert launcher.trainer_layout(["--device", "cuda"], nproc) == want


def test_the_trainer_layout_on_the_cpu_is_gloo():
    assert launcher.trainer_layout(["--device", "cpu", "--model", "resnet10"], 2) == (
        "gloo", 0, [])


def test_each_process_gets_torchruns_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("PET_NPROC_PER_NODE", raising=False)
    args = launcher.parse_args(["--trainer", "--workdir", str(tmp_path), "--metrics_port", "9100",
                                "--", "--model", "resnet18", "--resume", "RUN"])
    args.layout = ("gloo", 1, ["--dist_backend", "gloo"])
    procs = launcher.process_commands(args, str(tmp_path), {"PATH": "x"})
    assert len(procs) == 2
    for rank, (argv, env) in enumerate(procs):
        assert argv[:2] == [sys.executable, launcher.VICTIM]
        assert argv[2:4] == ["--dist_backend", "gloo"]
        assert argv[4:8] == ["--model", "resnet18", "--resume", "RUN"]
        assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"]) == (str(rank), "2", "0")
        assert env["MASTER_ADDR"] == "127.0.0.1" and env["PATH"] == "x"
        assert ("--metrics_port" in argv) == (rank == 0)
    assert procs[0][1]["MASTER_PORT"] == procs[1][1]["MASTER_PORT"]


def test_one_process_a_card_under_nccl(monkeypatch, tmp_path):
    monkeypatch.setenv("PET_NPROC_PER_NODE", "4")
    args = launcher.parse_args(["--trainer", "--workdir", str(tmp_path), "--", "--epochs", "1"])
    assert args.nproc == 4
    args.layout = ("nccl", 4, [])
    procs = launcher.process_commands(args, str(tmp_path), {})
    assert [env["LOCAL_RANK"] for _, env in procs] == ["0", "1", "2", "3"]
    assert all(argv[2:] == ["--epochs", "1"] for argv, _ in procs)


def test_flags_after_the_separator_need_trainer_mode(tmp_path):
    with pytest.raises(SystemExit):
        launcher.parse_args(["--workdir", str(tmp_path), "--", "--epochs", "1"])
    args = launcher.parse_args(["--workdir", str(tmp_path), "--nproc", "3"])
    assert (args.trainer, args.nproc, args.trainer_argv) == (False, 3, [])


def test_the_launches_are_each_processs_last_report_summed(tmp_path):
    log = matrix.kernels_log(str(tmp_path))
    with open(log, "w") as fh:
        for pid, n in ((1, 7), (2, 7), (1, 14), (3, 0)):
            fh.write(json.dumps({"pid": pid, "kernels": {"loss_fwd_launches": n}}) + "\n")
    assert matrix.kernel_launches(str(tmp_path)) == {"loss_fwd_launches": 21}
    assert matrix.kernel_launches(str(tmp_path / "none")) == {}


def test_the_recovery_times_read_the_supervisors_spans():
    events = [{"name": "launch", "ts": 0.0}, {"name": "child_run", "ts": 0.0, "dur": 10.0},
              {"name": "launch", "ts": 12.5}, {"name": "child_run", "ts": 12.5, "dur": 20.0}]
    assert matrix.timings(events) == {"supervised_s": 32.5, "relaunch_s": 2.5,
                                      "recovery_s": 22.5}
    assert matrix.timings(events[:2]) == {"supervised_s": 10.0}
