"""ReplicaFleetSupervisor — supervise/ generalized to a serving fleet.

The port of the JAX package's ``supervise/replica_fleet.py``, on the port's
``observe.MetricsScraper`` and recorder. The replica command defaults to
the port's fleet frontend (:func:`fleet_command`), each replica a process
with a CUDA context of its own.

The trainer supervisor (supervisor.py) babysits ONE child through exit
codes; this loop manages N serving replicas through the channels a serving
process exposes while alive: process liveness (``Popen.poll``) and the
``/metrics`` gauges (observe.MetricsScraper against each replica's port).
Every tick it scrapes the fleet into :class:`~supervise.replica.
ReplicaObservation` rows, asks the pure :class:`~supervise.replica.
ReplicaPolicy` what to do, and realizes the decisions:

- ``spawn_replica``  — allocate a port, launch the replica command with
  ``{port}`` substituted (the serve or serve.fleet CLI);
- ``restart_replica`` — SIGTERM -> grace -> SIGKILL the old process, then
  relaunch on the SAME port (the HTTP servers set SO_REUSEADDR), so
  clients and the scraper keep their address;
- ``drain_replica``  — graceful terminate and forget the slot (scale-down);
- ``give_up_replica`` — kill if needed, abandon the slot, keep the record.

Every observation and decision lands as recorder events
(``replica_spawn`` / ``replica_restart`` / ``replica_drain`` /
``replica_give_up`` / ``fleet_observation``) via utils.tracing, so the
scenario harness — and a fleet post-mortem — read the same jsonl format as
the trainer supervisor's.

Like everything in supervise/, this module never touches the device:
replicas are subprocesses that own their devices; the supervisor is a
host-only control plane. ``popen``/``clock``/``sleep``/``free_port``/
``scraper_factory`` are injectable together, so tests drive the whole loop
with fakes and no network.
"""

from __future__ import annotations

import dataclasses
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from simclr_pytorch_distributed_tpu_torch.supervise.observe import MetricsScraper
from simclr_pytorch_distributed_tpu_torch.supervise.replica import (
    DRAIN,
    GIVE_UP,
    RESTART,
    SPAWN,
    ReplicaObservation,
    ReplicaPolicy,
)
from simclr_pytorch_distributed_tpu_torch.utils import tracing


def default_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


FLEET_MODULE = "simclr_pytorch_distributed_tpu_torch.serve.fleet"


def fleet_command(*args: str) -> list:
    """The replica argv of the port's fleet frontend on port ``{port}``,
    with ``args`` (``--ckpt``, ``--device``, ...) after it."""
    return [sys.executable, "-m", FLEET_MODULE, "--port", "{port}", *args]


@dataclasses.dataclass
class ReplicaFleetConfig:
    """``command`` is the replica argv with ``{port}`` placeholders
    (every element is ``str.format``-ted with ``port=``; by default the
    port's fleet frontend, :func:`fleet_command`); the supervisor owns port
    assignment so replicas can't collide."""

    command: Sequence[str] = dataclasses.field(default_factory=fleet_command)
    min_replicas: int = 1
    max_replicas: int = 4
    poll_interval_s: float = 2.0
    grace_s: float = 10.0  # SIGTERM -> SIGKILL window on restart/drain
    host: str = "127.0.0.1"
    scrape_timeout_s: float = 2.0


class _Replica:
    def __init__(self, rid: int, port: int, proc, scraper, started: float):
        self.id = rid
        self.port = port
        self.proc = proc
        self.scraper = scraper
        self.started = started
        self.restarts = 0


class ReplicaFleetSupervisor:
    def __init__(
        self,
        config: ReplicaFleetConfig,
        policy: Optional[ReplicaPolicy] = None,
        *,
        popen: Callable = subprocess.Popen,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        free_port: Optional[Callable[[], int]] = None,
        scraper_factory: Optional[Callable[[int], object]] = None,
        env: Optional[dict] = None,
    ):
        self.config = config
        self.policy = policy if policy is not None else ReplicaPolicy(
            config.min_replicas, config.max_replicas
        )
        self._popen = popen
        self._clock = clock
        self._sleep = sleep
        self._free_port = free_port or (
            lambda: default_free_port(config.host)
        )
        self._scraper_factory = scraper_factory or (
            lambda port: MetricsScraper(
                port, host=config.host, timeout_s=config.scrape_timeout_s
            )
        )
        self._env = env
        self._replicas: Dict[int, _Replica] = {}
        self._next_id = 0
        self._gave_up: List[int] = []
        self._decisions: List[dict] = []  # every decision applied, in order

    # ------------------------------------------------------------ plumbing

    def _launch(self, port: int):
        cmd = [str(arg).format(port=port) for arg in self.config.command]
        return self._popen(cmd, env=self._env)

    def _terminate(self, replica: _Replica) -> Optional[int]:
        """SIGTERM, grace, SIGKILL — launch.Child's ladder on a raw Popen."""
        proc = replica.proc
        if proc.poll() is not None:
            return proc.returncode
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            return proc.poll()
        deadline = self._clock() + self.config.grace_s
        while self._clock() < deadline:
            if proc.poll() is not None:
                return proc.returncode
            self._sleep(0.1)
        try:
            proc.kill()
        except OSError:
            pass
        return proc.wait()

    def spawn(self, reason: str = "initial") -> _Replica:
        rid = self._next_id
        self._next_id += 1
        port = self._free_port()
        replica = _Replica(
            rid, port, self._launch(port), self._scraper_factory(port),
            self._clock(),
        )
        self._replicas[rid] = replica
        tracing.event(
            "replica_spawn", track="fleet:replicas", replica=rid, port=port,
            reason=reason,
        )
        return replica

    # ----------------------------------------------------------- the loop

    def observe(self) -> List[ReplicaObservation]:
        now = self._clock()
        out = []
        for replica in self._replicas.values():
            alive = replica.proc.poll() is None
            metrics = replica.scraper.scrape() if alive else None
            out.append(ReplicaObservation(
                replica=replica.id, alive=alive, metrics=metrics,
                age_s=now - replica.started,
            ))
        return out

    def step(self) -> List[dict]:
        """One observe -> decide -> apply tick; returns the applied
        decisions (dicts, as recorded)."""
        observations = self.observe()
        decisions = self.policy.decide(observations)
        applied = []
        for decision in decisions:
            record = {
                "action": decision.action,
                "replica": decision.replica,
                "reason": decision.reason,
            }
            if decision.action == SPAWN:
                replica = self.spawn(reason=decision.reason)
                record["replica"] = replica.id
                record["port"] = replica.port
            elif decision.action == RESTART:
                replica = self._replicas.get(decision.replica)
                if replica is None:
                    continue
                rc = self._terminate(replica)
                replica.proc = self._launch(replica.port)
                replica.started = self._clock()
                replica.restarts += 1
                record["port"] = replica.port
                record["old_returncode"] = rc
                tracing.event(
                    "replica_restart", track="fleet:replicas",
                    replica=replica.id, port=replica.port, returncode=rc,
                    reason=decision.reason,
                )
            elif decision.action == DRAIN:
                replica = self._replicas.pop(decision.replica, None)
                if replica is None:
                    continue
                rc = self._terminate(replica)
                record["returncode"] = rc
                tracing.event(
                    "replica_drain", track="fleet:replicas",
                    replica=replica.id, port=replica.port, returncode=rc,
                    reason=decision.reason,
                )
            elif decision.action == GIVE_UP:
                replica = self._replicas.pop(decision.replica, None)
                if replica is None:
                    continue
                self._terminate(replica)
                self._gave_up.append(replica.id)
                tracing.event(
                    "replica_give_up", track="fleet:replicas",
                    replica=replica.id, port=replica.port,
                    reason=decision.reason,
                )
            applied.append(record)
        self._decisions.extend(applied)
        return applied

    def run(
        self,
        duration_s: Optional[float] = None,
        until: Optional[Callable[[], bool]] = None,
    ) -> None:
        """Tick until ``until()`` (checked every poll) or the duration
        lapses. The first tick runs immediately, so a fresh supervisor
        spawns its floor without waiting a poll interval."""
        deadline = (
            self._clock() + duration_s if duration_s is not None else None
        )
        while True:
            self.step()
            if until is not None and until():
                return
            if deadline is not None and self._clock() >= deadline:
                return
            self._sleep(self.config.poll_interval_s)

    def stop_all(self) -> None:
        for replica in list(self._replicas.values()):
            self._terminate(replica)
        self._replicas.clear()

    # -------------------------------------------------------------- views

    def replicas(self) -> Dict[int, dict]:
        return {
            r.id: {
                "port": r.port,
                "pid": getattr(r.proc, "pid", None),
                "alive": r.proc.poll() is None,
                "restarts": r.restarts,
            }
            for r in self._replicas.values()
        }

    def decisions(self) -> List[dict]:
        return list(self._decisions)

    def gave_up(self) -> List[int]:
        return list(self._gave_up)
