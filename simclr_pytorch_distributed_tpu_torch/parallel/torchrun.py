"""``torchrun`` that keeps the trainers' typed exit codes.

    python -m simclr_pytorch_distributed_tpu_torch.parallel.torchrun \
        [torchrun flags] -m simclr_pytorch_distributed_tpu_torch.train.supcon ...

takes torchrun's own flags and environment (``PET_NPROC_PER_NODE`` for an
absent ``--nproc_per_node``, which ``supervise/launch.topology_env`` sets)
and runs torchrun's own agent, with two differences that the supervisor
needs:

- torchrun exits 1 whenever a worker exits non-zero; this launcher exits
  with the first failed worker's code instead (signal deaths as the shell's
  128+N), so a preemption stays 75, a health abort 3, a flush failure 2
  and a non-finite loss 1 (``utils/guard.py``, ``utils/preempt.py``);
- a SIGTERM or SIGINT to this launcher is passed to the workers, whose
  preemption machinery saves at the next flush boundary and exits 75, and
  the launcher then exits with their code; torchrun itself would shut the
  workers down and exit with its own signal error.

For that the agent runs on a thread of its own (torchrun registers its
signal handlers only on the main thread), and the main thread relays the
signals to the launcher's child processes, the workers. As with torchrun,
a SIGKILL of the launcher alone leaves the workers running: the agent
starts them in sessions of their own. So the supervisor's kill takes the
launcher's whole process tree (``supervise/launch.kill_tree``).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import List, Optional


def child_pids(pid: int) -> List[int]:
    """The live child processes of ``pid``, read from ``/proc``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name is in parentheses and may hold spaces
        fields = stat[stat.rfind(")") + 2:].split()
        if len(fields) > 1 and int(fields[1]) == pid:
            out.append(int(name))
    return out


def shell_code(exitcode: int) -> int:
    """A process's exit code as the shell reports it: a death by signal N,
    negative in ``subprocess``, becomes 128+N."""
    return 128 - exitcode if exitcode < 0 else exitcode


def main(argv: Optional[List[str]] = None) -> int:
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.run import parse_args, run

    args = parse_args(argv)
    outcome = {}

    def agent():
        try:
            run(args)
            outcome["rc"] = 0
        except ChildFailedError as e:
            _, failure = e.get_first_failure()
            outcome["rc"] = shell_code(failure.exitcode)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            outcome["error"] = e

    def relay(signum, frame):  # noqa: ARG001 - signal handler signature
        for pid in child_pids(os.getpid()):
            try:
                os.kill(pid, signum)
            except OSError:  # exited meanwhile
                pass

    previous = {s: signal.signal(s, relay) for s in (signal.SIGTERM, signal.SIGINT)}
    thread = threading.Thread(target=agent, name="torchrun-agent", daemon=True)
    try:
        thread.start()
        while thread.is_alive():
            thread.join(0.2)  # wakes the main thread for the relay
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    if "error" in outcome:
        raise outcome["error"]
    return outcome["rc"]


if __name__ == "__main__":
    sys.exit(main())
