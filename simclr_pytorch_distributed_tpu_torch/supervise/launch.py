"""Child-process mechanics: command construction, resume resolution,
topology, graceful termination (the port's copy of JAX
``supervise/launch.py``).

The resume scan (:func:`find_resume_dir`) is the logic the shell launchers
carry in awk: the newest run folder under ``<workdir>/*_models/``,
excluding the probe's and CE trainer's ``classifier_*``/``ce_*`` folders by
BASENAME (a workdir path containing ``ce_`` must not hide every
candidate). ``--resume`` is APPENDED to the user's command: argparse is
last-wins, so a freshly resolved run folder beats any stale ``--resume``
the user passed.

Topology (:func:`topology_env`): "relaunch resized" hands the child a
different process count. The port scales by processes under ``torchrun``
(``parallel/mesh.py``), and torchrun reads an absent ``--nproc_per_node``
from ``PET_NPROC_PER_NODE`` (``torch.distributed.argparse_util.env``), so
the hook sets that variable. A checkpoint resumes under any world size
(``utils/checkpoint.py``), which is what makes the relaunch legal.

Kill (:meth:`Child.terminate_gracefully`): when the grace window lapses,
SIGKILL goes to the child's whole process tree, read from ``/proc``. The
port's launchers make the child ``parallel/torchrun.py``, whose workers run
in sessions of their own: a SIGKILL of the launcher alone would leave a
wedged worker holding the card and the run folder beside its relaunch.

Share (:func:`share_env`): "relaunch rebalanced", the straggler ladder's
first rung, carries a ``host:factor`` hint (``FLEET_SHARE_HINT``,
``data/pipeline.FLEET_SHARE_ENV``) into the relaunch: the named process
should run at that fraction of its uniform share. On a real fleet the
scheduler realizes the hint; on one host it is carried, recorded and
verifiable in the relaunch's environment (``scripts/port_fleet_launcher.py``
echoes it into its result file).
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Dict, List, Optional, Sequence

from simclr_pytorch_distributed_tpu_torch.data.pipeline import FLEET_SHARE_ENV
from simclr_pytorch_distributed_tpu_torch.parallel.torchrun import child_pids
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import resolve_resume_path

# probe/CE run folders are never resume candidates for a pretrain relaunch
EXCLUDED_RUN_PREFIXES = ("classifier_", "ce_")

# torchrun's environment spelling of --nproc_per_node
NPROC_ENV = "PET_NPROC_PER_NODE"


def _has_complete_checkpoint(run_dir: str) -> bool:
    """The trainer's own judgment (``resolve_resume_path``): at least one
    ``*.pth`` that loads and holds a training position; a torn file never
    counts."""
    try:
        resolve_resume_path(run_dir)
    except FileNotFoundError:
        return False
    return True


def find_resume_dir(
    workdir: str, exclude: tuple = EXCLUDED_RUN_PREFIXES,
    require_checkpoint: bool = False,
) -> Optional[str]:
    """Newest run folder under ``<workdir>/*_models/`` whose basename is not
    in ``exclude``; None when there is nothing to resume from (first
    launch, or the child died before creating its run folder).

    The default exclusion targets a pretrain job. A supervisor babysitting
    the probe or CE trainer passes ``exclude=()`` (``--all_run_dirs``):
    their run folders ARE the ``classifier_*``/``ce_*`` ones.

    ``require_checkpoint`` keeps only run folders holding at least one
    complete full-state ``.pth``, judged as ``resolve_resume_path`` judges
    it: the ``--resume`` injection mode. Without it, a child that died
    before its first save leaves an empty newest folder, and resuming from
    it fails on every retry until the budget burns; with it, the
    supervisor falls back to an older complete run or a fresh start. The
    watch channel keeps the unfiltered newest folder: the current run's
    artifacts live there whether or not it has saved yet."""
    candidates = []
    for models in sorted(
        d for d in (os.path.join(workdir, n) for n in (
            os.listdir(workdir) if os.path.isdir(workdir) else []
        )) if d.endswith("_models") and os.path.isdir(d)
    ):
        for name in os.listdir(models):
            path = os.path.join(models, name)
            if os.path.isdir(path) and not name.startswith(tuple(exclude)):
                if require_checkpoint and not _has_complete_checkpoint(path):
                    continue
                candidates.append(path)
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def topology_env(
    devices: Optional[int], base_env: Optional[Dict[str, str]] = None
) -> Dict[str, str]:
    """The child's environment for a process count.

    ``devices=None`` leaves the environment as it is (the supervisor does
    not manage topology unless asked). Otherwise :data:`NPROC_ENV` is set
    to the count, replacing any old value; every other variable is left
    alone."""
    env = dict(os.environ if base_env is None else base_env)
    if devices is None:
        return env
    env[NPROC_ENV] = str(int(devices))
    return env


def share_env(
    share: Optional[str], base_env: Optional[Dict[str, str]] = None
) -> Dict[str, str]:
    """The child's environment for a rebalance hint (module docstring).

    ``share=None`` REMOVES any stale hint rather than inheriting it: after
    the exclusion rung (or an operator resize) the shares are uniform again
    across the new topology, and a hint left from an earlier rebalance
    would starve a process that is no longer slow."""
    env = dict(os.environ if base_env is None else base_env)
    if share:
        env[FLEET_SHARE_ENV] = str(share)
    else:
        env.pop(FLEET_SHARE_ENV, None)
    return env


def kill_tree(pid: int) -> List[int]:
    """SIGKILL ``pid`` and every process below it; returns the pids
    signalled. Each process is stopped before its children are read, so
    none forks a new one between the read and the kill; a process group
    would not do, since torchrun's workers leave the launcher's."""
    stopped, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            os.kill(p, signal.SIGSTOP)
        except OSError:  # exited meanwhile
            continue
        stopped.append(p)
        todo.extend(child_pids(p))
    for p in stopped:
        try:
            os.kill(p, signal.SIGKILL)
        except OSError:
            pass
    return stopped


def build_command(
    command: Sequence[str], resume_dir: Optional[str]
) -> List[str]:
    """The user's command, with ``--resume <dir>`` appended on relaunches
    (last-wins over any user-supplied ``--resume``)."""
    cmd = list(command)
    if resume_dir:
        cmd += ["--resume", resume_dir]
    return cmd


class Child:
    """One supervised attempt: a Popen plus the bookkeeping the supervisor
    needs (which topology and share it runs with, what it resumed from).

    stdout/stderr pass through to the supervisor's own, so the trainer's
    log lines stay visible as under the shell launcher; the recorder, not
    a pipe, is the supervisor's structured view of the child.
    """

    def __init__(
        self,
        command: Sequence[str],
        resume_dir: Optional[str] = None,
        devices: Optional[int] = None,
        share: Optional[str] = None,
        cwd: Optional[str] = None,
    ):
        self.command = build_command(command, resume_dir)
        self.devices = devices
        self.share = share
        self.resume_dir = resume_dir
        self.proc = subprocess.Popen(
            self.command, env=share_env(share, topology_env(devices)),
            cwd=cwd,
        )

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self.proc.wait(timeout=timeout)

    def terminate_gracefully(
        self, grace_s: float, sleep=time.sleep, poll_s: float = 0.1,
        clock=time.monotonic,
    ) -> int:
        """SIGTERM, give the preemption machinery its grace window (the
        emergency save and exit 75), then SIGKILL the child's process tree
        (:func:`kill_tree`). Returns the child's
        returncode. ``sleep`` and ``clock`` are injected together (the
        Supervisor passes its own pair): a fake sleep against the real clock
        would spin the poll loop for the whole grace window."""
        if self.proc.poll() is not None:
            return self.proc.returncode
        try:
            self.proc.send_signal(signal.SIGTERM)
        except OSError:  # exited between poll and signal
            return self.proc.wait()
        deadline = clock() + grace_s
        while clock() < deadline:
            if self.proc.poll() is not None:
                return self.proc.returncode
            sleep(poll_s)
        kill_tree(self.proc.pid)  # not yet reaped: the pid is still the child's
        return self.proc.wait()
