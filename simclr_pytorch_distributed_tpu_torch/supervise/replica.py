"""ReplicaPolicy — the serving-fleet decision table, pure like policy.py.

The port's copy of the JAX package's ``supervise/replica.py`` (standard
library only): the same table, so the port's replica fleet decides as the
JAX package's does on the same observations.

The trainer supervisor judges ONE child by how it EXITS (exit codes are the
trainer's contract). A serving replica is judged while it RUNS: liveness
and saturation live in the ``/metrics`` gauges the serve stack already
exports, and the fleet decision is about N replicas at once. Same
discipline as :mod:`supervise.policy`: :meth:`ReplicaPolicy.decide` takes
observations, returns decisions, performs no I/O and reads no clocks, so
the tests enumerate the whole table without a process.

Per-replica classification (:func:`classify`), evaluated in this order:

==============  ========================================================
class           condition (scraped serve_batcher_* gauges)
==============  ========================================================
dead            the process has exited
starting        no scrape yet, but younger than ``startup_grace_s`` —
                imports and the model's load take real time; silence
                here is expected, not a failure
unscrapeable    no scrape past the grace — the HTTP plane is gone even
                though the process runs (wedged interpreter, bound port
                lost); counts strikes, ``unscrape_strikes`` of them in a
                row escalate to a restart
stalled         work is pending (queue_depth + inflight_batches > 0) and
                ``last_completion_age_s`` exceeds ``stall_age_s`` — the
                replica owes completions and is not delivering (the
                serving analogue of the trainer's boundary-age liveness)
saturated       ``pipeline_occupancy >= occ_hi`` OR
                ``queue_depth >= queue_hi`` — admitting more traffic
                means queueing latency, the fleet should grow
idle            no queued or in-flight work and
                ``pipeline_occupancy <= occ_lo`` — shrink candidate
busy            everything else — healthy, leave it alone
==============  ========================================================

Fleet decisions (:meth:`decide`), most-urgent first; repair beats scaling:

- dead / stalled / unscrapeable-past-strikes -> ``restart_replica``,
  bounded by a PER-REPLICA restart budget (``max_restarts``); an exhausted
  budget -> ``give_up_replica`` — that replica (its port, its slot) is
  abandoned and reported, never silently relaunched forever;
- fleet below ``min_replicas`` (after give-ups or drains) -> one
  ``spawn_replica`` per decide call (fresh slot, fresh budget);
- any replica saturated and the fleet below ``max_replicas`` -> one
  ``spawn_replica`` per decide call (scaling is damped: one step per
  observation interval, so a burst can't overshoot to max in one tick);
- no one saturated, fleet above ``min_replicas``, some replica idle ->
  ``drain_replica`` for the HIGHEST-id idle replica (newest first: the
  scale-up order reversed), one per call;
- otherwise no decisions (steady state).

A replica that scrapes clean resets its unscrape strikes (recovery), but
restart budgets never refill — a flapping replica must eventually surface
to a human, exactly like the trainer policy's ``max_restarts``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set

# the scraped gauge names (serve/server.py serve_metrics_fn and
# serve/fleet/frontend.py fleet_metrics_fn both export them unlabeled,
# which is all observe.parse_prometheus_text reads)
AGE_GAUGE = "serve_batcher_last_completion_age_s"
QUEUE_GAUGE = "serve_batcher_queue_depth"
INFLIGHT_GAUGE = "serve_batcher_inflight_batches"
OCC_GAUGE = "serve_batcher_pipeline_occupancy"

# classification states
DEAD = "dead"
STARTING = "starting"
UNSCRAPEABLE = "unscrapeable"
STALLED = "stalled"
SATURATED = "saturated"
IDLE = "idle"
BUSY = "busy"

# ReplicaDecision.action values (strings: they land in recorder events and
# the evidence artifact as JSON, like policy.py's)
SPAWN = "spawn_replica"
RESTART = "restart_replica"
DRAIN = "drain_replica"
GIVE_UP = "give_up_replica"


@dataclasses.dataclass(frozen=True)
class ReplicaObservation:
    """One replica at one observation instant, as the supervisor saw it.

    ``metrics`` is the scraped gauge dict or None (scrape failed — which a
    dead HTTP plane and a not-yet-up replica both produce; ``age_s``, the
    seconds since the replica was spawned, is what separates them against
    ``startup_grace_s``). The policy reads clocks from NOWHERE else."""

    replica: int
    alive: bool
    metrics: Optional[Mapping[str, float]] = None
    age_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReplicaDecision:
    action: str
    replica: int = -1  # -1: a fresh slot (spawn) — the supervisor assigns
    reason: str = ""


def classify(
    obs: ReplicaObservation,
    *,
    startup_grace_s: float = 60.0,
    stall_age_s: float = 30.0,
    occ_hi: float = 0.9,
    queue_hi: float = 64.0,
    occ_lo: float = 0.1,
) -> str:
    """The per-replica row of the decision table (module docstring)."""
    if not obs.alive:
        return DEAD
    if obs.metrics is None:
        return STARTING if obs.age_s <= startup_grace_s else UNSCRAPEABLE
    m = obs.metrics
    queued = m.get(QUEUE_GAUGE, 0.0)
    inflight = m.get(INFLIGHT_GAUGE, 0.0)
    age = m.get(AGE_GAUGE, 0.0)
    occ = m.get(OCC_GAUGE, 0.0)
    if (queued > 0 or inflight > 0) and age > stall_age_s:
        return STALLED
    if occ >= occ_hi or queued >= queue_hi:
        return SATURATED
    if queued == 0 and inflight == 0 and occ <= occ_lo:
        return IDLE
    return BUSY


class ReplicaPolicy:
    """Decision state across one supervised fleet: per-replica restart
    budgets, unscrape strike counters, and the abandoned set."""

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 4,
        *,
        startup_grace_s: float = 60.0,
        stall_age_s: float = 30.0,
        occ_hi: float = 0.9,
        queue_hi: float = 64.0,
        occ_lo: float = 0.1,
        max_restarts: int = 3,
        unscrape_strikes: int = 3,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}"
            )
        if max_restarts < 0 or unscrape_strikes < 1:
            raise ValueError(
                f"need max_restarts >= 0 and unscrape_strikes >= 1, got "
                f"{max_restarts}/{unscrape_strikes}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.startup_grace_s = float(startup_grace_s)
        self.stall_age_s = float(stall_age_s)
        self.occ_hi = float(occ_hi)
        self.queue_hi = float(queue_hi)
        self.occ_lo = float(occ_lo)
        self.max_restarts = int(max_restarts)
        self.unscrape_strikes = int(unscrape_strikes)
        self.restarts: Dict[int, int] = {}
        self.strikes: Dict[int, int] = {}
        self.given_up: Set[int] = set()

    def classify(self, obs: ReplicaObservation) -> str:
        return classify(
            obs,
            startup_grace_s=self.startup_grace_s,
            stall_age_s=self.stall_age_s,
            occ_hi=self.occ_hi,
            queue_hi=self.queue_hi,
            occ_lo=self.occ_lo,
        )

    def _repair(self, obs: ReplicaObservation, why: str) -> ReplicaDecision:
        r = obs.replica
        used = self.restarts.get(r, 0)
        if used >= self.max_restarts:
            self.given_up.add(r)
            return ReplicaDecision(
                GIVE_UP, r,
                f"replica {r} {why} with restart budget exhausted "
                f"({used}/{self.max_restarts}): abandoning the slot — "
                f"a human should look",
            )
        self.restarts[r] = used + 1
        return ReplicaDecision(
            RESTART, r,
            f"replica {r} {why}: restart "
            f"({used + 1}/{self.max_restarts} of budget)",
        )

    def decide(
        self, observations: Sequence[ReplicaObservation]
    ) -> List[ReplicaDecision]:
        decisions: List[ReplicaDecision] = []
        classes: Dict[int, str] = {}
        for obs in sorted(observations, key=lambda o: o.replica):
            if obs.replica in self.given_up:
                continue
            cls = self.classify(obs)
            classes[obs.replica] = cls
            if cls == DEAD:
                decisions.append(self._repair(obs, "process exited"))
            elif cls == STALLED:
                age = (obs.metrics or {}).get(AGE_GAUGE, 0.0)
                decisions.append(self._repair(
                    obs,
                    f"stalled (work pending, last completion {age:.1f}s "
                    f"ago > {self.stall_age_s:g}s)",
                ))
            elif cls == UNSCRAPEABLE:
                strikes = self.strikes.get(obs.replica, 0) + 1
                self.strikes[obs.replica] = strikes
                if strikes >= self.unscrape_strikes:
                    self.strikes[obs.replica] = 0
                    decisions.append(self._repair(
                        obs,
                        f"unscrapeable {strikes} consecutive polls "
                        f"(HTTP plane gone while the process runs)",
                    ))
            else:
                self.strikes[obs.replica] = 0

        # fleet size the scaling rows reason about: every slot still
        # managed (restarting replicas are coming back, so they count)
        managed = [r for r in classes if r not in self.given_up]
        n = len(managed)
        if n < self.min_replicas:
            decisions.append(ReplicaDecision(
                SPAWN, -1,
                f"fleet at {n} < min_replicas {self.min_replicas}: "
                f"spawning a fresh replica",
            ))
            return decisions
        saturated = [r for r in managed if classes[r] == SATURATED]
        if saturated and n < self.max_replicas:
            decisions.append(ReplicaDecision(
                SPAWN, -1,
                f"replica(s) {saturated} saturated at fleet size {n} < "
                f"max {self.max_replicas}: spawning one more",
            ))
            return decisions
        if not saturated and n > self.min_replicas:
            idle = [r for r in managed if classes[r] == IDLE]
            if idle:
                victim = max(idle)
                decisions.append(ReplicaDecision(
                    DRAIN, victim,
                    f"replica {victim} idle at fleet size {n} > min "
                    f"{self.min_replicas}: draining it",
                ))
        return decisions
