"""The supervisor's decision policy: pure, explicit, testable (the port's
copy of JAX ``supervise/policy.py``; it imports nothing of the JAX package).

Everything the supervisor does flows through :meth:`DecisionPolicy.decide`:
one ``ExitObservation`` (how the child left, what the channels saw on the
way) in, one ``Decision`` out. The method performs no I/O and reads no
clocks, so ``tests/test_torch_port_supervise_policy.py`` walks the whole
decision table against the JAX policy without launching a process.

The classification input is the typed exit-code surface of the port's
trainers (``utils/guard.py``, ``utils/preempt.py``):

==========================  =============================================
child exit                  decision
==========================  =============================================
0                           DONE
75 (preempt, state saved)   RESTART with ``--resume`` — immediately, no
                            backoff (the exit was clean by contract); if a
                            resize target is pending, RESTART_RESIZED onto
                            it instead (a checkpoint resumes under any
                            world size, utils/checkpoint.py). Does NOT
                            apply when the 75 was forced by the
                            supervisor's own stall kill — that stays a
                            backoff restart (see the stall row)
3 (health abort)            GIVE_UP — collapse lives in the weights, so a
                            relaunch from the crash save just re-detects
                            it; a human changes the recipe
1 (NaN) / 2 (flush)         BACKOFF then restart with ``--resume`` — NaN
                            may be a transient (bad host, ECC hiccup) and
                            the in-driver ``--nan_policy rollback`` is the
                            principled self-heal; flush failures are
                            I/O-flavored and often clear
signal death (rc < 0)       BACKOFF then restart with ``--resume`` —
                            kill -9 / OOM left no grace, resume resolution
                            picks the newest COMPLETE save
supervisor-observed stall   the supervisor killed the child itself
                            (liveness age or a watchdog dump); BACKOFF
                            then restart with ``--resume``
75 + persistent straggler   the supervisor preempted the child itself
                            after a K-of-N persistence verdict
                            (observe.StragglerTracker): the STRAGGLER
                            LADDER — first verdict RESTART_REBALANCED
                            (shrink the slow host's share; the epoch
                            permutation is process-count-independent, so
                            the stream survives), second RESTART_RESIZED
                            excluding the slow host (the elastic-resume
                            path), third GIVE_UP — a host that stays slow
                            through rebalance AND exclusion means the
                            diagnosis is wrong, and a human should look.
                            Never fires over a pending OPERATOR resize
                            (the explicit request wins), always bounded
                            by the restart budget, and a run that later
                            preempts cleanly with no verdict resets the
                            ladder (recovery). A mitigation preempt the
                            child did NOT honor (grace lapsed to SIGKILL)
                            falls through to the signal-death row — the
                            ladder only advances on the clean exit 75 the
                            mitigation contract promises
anything else               BACKOFF then restart — bounded by the budget,
                            so a permanent failure (bad flag, import
                            error) burns at most ``max_restarts`` cheap
                            attempts before GIVE_UP reports the real code
==========================  =============================================

Restart budget: ``max_restarts`` bounds TOTAL relaunches (the launcher
loop's ``PREEMPT_RETRIES`` contract, now shared by every failure class —
straggler mitigations included). Backoff is exponential in CONSECUTIVE
failures — a clean preemption resets the streak (the fleet is healthy,
the scheduler is just busy) — capped at ``backoff_max_s``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from simclr_pytorch_distributed_tpu_torch.utils import guard, preempt

# Decision.action values (strings, not an enum: they go straight into
# recorder events and the evidence artifact as JSON)
DONE = "done"
RESTART = "restart_resume"
RESTART_RESIZED = "restart_resized"
RESTART_REBALANCED = "restart_rebalanced"
BACKOFF_RESTART = "backoff_restart"
GIVE_UP = "give_up"
# emitted by the SUPERVISOR loop (not decide()): the supervisor itself was
# SIGTERM/SIGINT'd and relayed the signal to the child instead of relaunching
SHUTDOWN = "shutdown"

# the rebalance rung's share shrink: the slow host keeps this fraction of
# its uniform per-process share (the hint launch.share_env carries into the
# relaunch; on a real fleet the scheduler realizes it)
REBALANCE_FACTOR = 0.5


@dataclasses.dataclass(frozen=True)
class ExitObservation:
    """One child exit, as the supervisor saw it.

    ``returncode`` follows the subprocess convention (negative = died to
    that signal). ``stalled`` means the SUPERVISOR killed the child after
    a liveness verdict (boundary age over the deadline, or a watchdog
    stall dump appeared) — the returncode is then just our own SIGKILL.
    ``stall_dumps``/``health_alarms`` count artifacts observed during the
    attempt (forensics context for the decision event; a health ALARM
    under ``--health_policy warn`` does not by itself end a run — only
    the exit code 3 of an ``abort`` policy does).

    ``straggler_persistent`` means the SUPERVISOR gracefully preempted
    the child after a K-of-N straggler persistence verdict
    (observe.StragglerTracker) — the mitigation request the ladder acts
    on when the exit is the clean 75 the preempt contract promises.
    ``straggler_host``/``straggler_skew_s``/``processes`` carry the
    verdict's context (who, how slow, out of how many) for the rebalance
    share and the exclusion topology; -1/0 when unknown.
    """

    returncode: int
    stalled: bool = False
    stall_dumps: int = 0
    health_alarms: int = 0
    straggler_persistent: bool = False
    straggler_host: int = -1
    straggler_skew_s: float = 0.0
    processes: int = 0


@dataclasses.dataclass(frozen=True)
class Decision:
    """What the supervisor does next. ``delay_s`` is slept before the
    relaunch; ``devices`` is the new topology for RESTART_RESIZED (None
    everywhere else); ``share`` is the ``host:factor`` rebalance hint for
    RESTART_REBALANCED (launch.share_env carries it into the relaunch);
    ``reason`` is the human- and JSON-facing line."""

    action: str
    reason: str
    delay_s: float = 0.0
    devices: Optional[int] = None
    share: Optional[str] = None


class DecisionPolicy:
    """Decision state across one supervised run: the restart budget, the
    consecutive-failure streak the backoff grows on, and the pending
    resize target (set by the supervisor when a resize request arrives,
    consumed by the first restartable exit that follows)."""

    def __init__(
        self,
        max_restarts: int = 3,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 60.0,
    ):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError(
                f"need 0 < backoff_base_s <= backoff_max_s, got "
                f"{backoff_base_s}/{backoff_max_s}"
            )
        self.max_restarts = max_restarts
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.restarts = 0          # relaunches performed so far
        self.failures = 0          # consecutive non-clean exits (backoff input)
        self.pending_resize: Optional[int] = None
        # straggler-ladder rung already taken: 0 none (warn territory),
        # 1 rebalanced, 2 excluded — the NEXT verdict takes rung+1
        self.straggler_level = 0

    # ---------------------------------------------------------------- helpers
    def backoff_s(self) -> float:
        """Exponential backoff for the CURRENT consecutive-failure streak:
        base * 2^(failures-1), capped. ``failures`` is incremented before
        this is read (a first failure waits the base)."""
        exp = max(0, self.failures - 1)
        return min(self.backoff_max_s, self.backoff_base_s * (2.0 ** exp))

    def request_resize(self, devices: int) -> None:
        if devices <= 0:
            raise ValueError(f"resize target must be positive, got {devices}")
        self.pending_resize = int(devices)

    def _restart(self, action: str, reason: str, delay_s: float = 0.0) -> Decision:
        """Book a restart; a pending resize upgrades any restartable
        decision (the resize request was the OPERATOR'S, so it must not be
        lost to an unlucky crash landing before the preempt exit)."""
        self.restarts += 1
        if self.pending_resize is not None:
            devices, self.pending_resize = self.pending_resize, None
            return Decision(
                RESTART_RESIZED,
                f"{reason}; resizing to {devices} device(s)",
                delay_s=delay_s, devices=devices,
            )
        return Decision(action, reason, delay_s=delay_s)

    def _mitigate_straggler(self, obs: ExitObservation) -> Decision:
        """The escalation ladder, one rung per persistence verdict. The
        warn rung is rung 0 and lives OUTSIDE this method: per-boundary
        findings and the persistence verdict itself are recorded by the
        supervisor before any preempt (and are the ONLY response in
        warn-only mode). Reaching here means the supervisor already
        preempted for mitigation and the child exited cleanly."""
        self.straggler_level += 1
        host = obs.straggler_host
        skew = obs.straggler_skew_s
        if self.straggler_level == 1:
            self.restarts += 1
            return Decision(
                RESTART_REBALANCED,
                f"persistent straggler host {host} (skew {skew:.3f}s): "
                f"rebalancing its share to {REBALANCE_FACTOR:g}x and "
                f"resuming",
                share=f"{host}:{REBALANCE_FACTOR:g}",
            )
        if self.straggler_level == 2:
            self.restarts += 1
            devices = (
                max(1, obs.processes - 1) if obs.processes > 1 else None
            )
            return Decision(
                RESTART_RESIZED,
                f"straggler host {host} persists after rebalance (skew "
                f"{skew:.3f}s): excluding it and resuming on the "
                f"remaining host(s)",
                devices=devices,
            )
        return Decision(
            GIVE_UP,
            f"straggler host {host} persists after rebalance AND "
            f"exclusion (skew {skew:.3f}s): mitigation ladder exhausted "
            f"— the slowness is not where the fleet thinks it is; a "
            f"human should look",
        )

    # ----------------------------------------------------------------- decide
    def decide(self, obs: ExitObservation) -> Decision:
        rc = obs.returncode
        if rc == 0:
            return Decision(DONE, "child completed (exit 0)")
        if rc == guard.EXIT_HEALTH:
            # never retried: collapse lives in the weights, so a relaunch
            # from the crash save re-detects it one window in; the budget
            # is irrelevant
            return Decision(
                GIVE_UP,
                "representation-health abort (exit 3): collapse lives in "
                "the weights — change the recipe, do not relaunch",
            )
        if self.restarts >= self.max_restarts:
            return Decision(
                GIVE_UP,
                f"restart budget exhausted ({self.restarts}/"
                f"{self.max_restarts}); last exit {rc}",
            )
        if rc == preempt.EXIT_PREEMPTED and not obs.stalled:
            # clean by contract (state saved) — no backoff, and the
            # failure streak resets: preemption is scheduling, not illness.
            # NOT taken when the SUPERVISOR initiated the kill (obs.stalled):
            # a responsive-enough child turns our stall SIGTERM into a tidy
            # exit 75, but the condition that triggered the kill is still a
            # failure — streak-resetting it would hammer the restart budget
            # in a tight kill/relaunch loop and misattribute the
            # supervisor's own kill as scheduler preemption in post-mortems
            self.failures = 0
            if obs.straggler_persistent:
                if self.pending_resize is not None:
                    # operator-resize precedence: the explicit request
                    # wins over the inferred mitigation (the supervisor
                    # also refuses to INITIATE one over a pending resize
                    # — this row covers the race where both land on the
                    # same exit); _restart consumes the pending target
                    return self._restart(
                        RESTART,
                        "preempted with a persistent-straggler verdict, "
                        "but an operator resize is pending: the explicit "
                        "request wins",
                    )
                return self._mitigate_straggler(obs)
            # a clean, boundary-rich exit with NO verdict in force means
            # the mitigation (or the fleet) recovered: the ladder resets,
            # so a straggler relapse much later starts at rebalance again
            # instead of escalating straight to give_up
            self.straggler_level = 0
            return self._restart(
                RESTART, "preempted (exit 75, state saved): resume"
            )
        self.failures += 1
        delay = self.backoff_s()
        if obs.stalled:
            reason = (
                f"stalled (boundary liveness/watchdog; {obs.stall_dumps} "
                f"dump(s)): killed, resume after {delay:g}s"
            )
            if rc == preempt.EXIT_PREEMPTED:
                reason += " (child honored SIGTERM; state saved)"
        elif rc == guard.EXIT_NONFINITE:
            # exit 1 is also the interpreter's code for any unhandled
            # crash — both shapes get the same bounded resume-and-retry
            reason = (
                f"non-finite loss abort or unhandled crash (exit 1): "
                f"resume after {delay:g}s (for NaNs, consider "
                f"--nan_policy rollback)"
            )
        elif rc == guard.EXIT_FLUSH:
            # exit 2 is also argparse's usage-error code — a typo'd flag
            # lands here too, so the reason names both readings
            reason = (
                f"telemetry flush failure or usage error (exit 2): resume "
                f"after {delay:g}s (if it recurs instantly, check the "
                f"command's flags)"
            )
        elif rc < 0:
            reason = (
                f"died to signal {-rc} (no grace): resume from the newest "
                f"complete save after {delay:g}s"
            )
        else:
            reason = f"unclassified exit {rc}: resume after {delay:g}s"
        return self._restart(BACKOFF_RESTART, reason, delay_s=delay)
