"""The supervisor loop: launch, watch, decide, relaunch (the port's copy of
JAX ``supervise/supervisor.py``).

One :class:`Supervisor` owns one training job. Each attempt it launches the
child (``launch.Child``), then polls three channels every ``poll_s``:

- the child's returncode (``subprocess``: the typed exit-code surface);
- the ``--metrics_port`` sidecar (``observe.MetricsScraper``):
  ``train_last_boundary_age_seconds`` past ``stall_secs`` is an OUTSIDE
  liveness verdict; the supervisor terminates the child (SIGTERM first, so
  the preemption machinery gets its grace window to save; SIGKILL after)
  and restarts with resume;
- the run folder (``observe.RunDirWatcher``): stall-watchdog dumps (an
  INSIDE liveness verdict: the watchdog only observes, the supervisor
  acts), ``health_alarm``/``nan_rollback``/``preempt_exit``/
  ``stall_detected`` recorder events, and new checkpoints, all re-recorded
  into the supervisor's own timeline.

Elastic resize: dropping a ``resize_request`` file (one integer) into the
supervisor's folder makes the supervisor gracefully preempt the child and
relaunch it on that many processes (``launch.topology_env``); the decision
lands as ``restart_resized`` and the relaunch passes ``--resume``: a
checkpoint resumes under any world size (``utils/checkpoint.py``). A
pending resize also upgrades any other restartable exit, so an operator's
resize survives an unlucky crash.

Straggler mitigation: the sidecar's boundary-skew gauges
(``utils/telemetry.py``) feed ``observe.StragglerTracker``; K-of-N
boundaries naming the same process above ``straggler_skew_secs`` is a
PERSISTENCE verdict, always recorded as a ``straggler_persistent`` event
(the warn rung). With ``straggler_mitigate`` on, a verdict triggers the
same graceful preempt as a resize (``straggler_mitigation`` phase=preempt,
SIGTERM -> emergency save -> exit 75) and the policy ladder decides the
relaunch: ``restart_rebalanced`` carrying a ``FLEET_SHARE_HINT`` into the
environment, then ``restart_resized`` excluding the process, then
``give_up``. A pending operator resize always wins over mitigation, and the
restart budget caps the ladder like every other class.

Every observation and decision is an event in the supervisor's own
``events.jsonl`` (``<workdir>/supervise/``, the port's ``FlightRecorder``
and ``run_paths`` session files), so one pass over trainer and supervisor
files tells the whole story of a babysat run. Clock, sleep and scraper are
injectable: ``tests/test_torch_port_supervise_run.py`` drives the loop
against scripted children without real waiting.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Callable, List, Optional

from simclr_pytorch_distributed_tpu_torch.parallel.torchrun import shell_code
from simclr_pytorch_distributed_tpu_torch.supervise import launch, observe, policy
from simclr_pytorch_distributed_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

RESIZE_REQUEST_FILE = "resize_request"


@dataclasses.dataclass
class SuperviseConfig:
    """The supervisor CLI surface (see __main__.py for the flag help)."""

    command: List[str]
    workdir: str = "./work_space"
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    poll_s: float = 1.0
    stall_secs: float = 0.0          # 0 = no liveness-kill (observe only)
    # boundary-skew bar (s) for the per-boundary straggler finding scraped
    # off the child's train_boundary_skew_seconds gauge; 0 = off. Findings
    # feed observe.StragglerTracker's K-of-N persistence verdict; what a
    # verdict DOES depends on straggler_mitigate below.
    straggler_skew_secs: float = 1.0
    # persistence: a straggler is persistent after straggler_persist_k of
    # the last straggler_window_n boundaries named the SAME host above the
    # bar (hysteresis: one boundary of skew — a GC pause — never triggers)
    straggler_persist_k: int = 3
    straggler_window_n: int = 5
    # False (default): verdicts are RECORDED (straggler_persistent events
    # — the warn rung of the ladder) but never acted on. True: a verdict triggers a graceful mitigation preempt and
    # the policy ladder (rebalance -> exclude -> give_up), budget-capped,
    # never over a pending operator resize.
    straggler_mitigate: bool = False
    grace_secs: float = 20.0         # SIGTERM -> SIGKILL window
    metrics_port: int = 0            # the CHILD's sidecar port; 0 = no scrape
    metrics_host: str = "127.0.0.1"
    devices: int = 0                 # initial process count; 0 = unmanaged
    supervise_dir: str = ""          # default: <workdir>/supervise
    # False (the pretrain default) excludes classifier_*/ce_* folders from
    # run-dir resolution; True is for supervising the probe/CE trainers,
    # whose run dirs ARE those folders — without it the watch channel
    # (stall dumps, recorder events, checkpoints) would be blind and
    # --resume would point at a stale pretrain dir
    all_run_dirs: bool = False


class Supervisor:
    def __init__(
        self,
        cfg: SuperviseConfig,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        scraper: Optional[observe.MetricsScraper] = None,
    ):
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        self.supervise_dir = cfg.supervise_dir or os.path.join(
            cfg.workdir, "supervise"
        )
        os.makedirs(self.supervise_dir, exist_ok=True)
        events, trace = tracing.run_paths(self.supervise_dir)
        self.recorder = tracing.FlightRecorder(
            events, clock=clock, trace_path=trace
        )
        self.policy = policy.DecisionPolicy(
            max_restarts=cfg.max_restarts,
            backoff_base_s=cfg.backoff_base_s,
            backoff_max_s=cfg.backoff_max_s,
        )
        self.scraper = scraper
        if scraper is None and cfg.metrics_port:
            self.scraper = observe.MetricsScraper(
                cfg.metrics_port, cfg.metrics_host
            )
        self.child: Optional[launch.Child] = None
        self.decisions: List[policy.Decision] = []  # the run's decision log
        self._run_dir_exclude = (
            () if cfg.all_run_dirs else launch.EXCLUDED_RUN_PREFIXES
        )
        # one PERSISTENT watcher per run dir: a relaunch within the same
        # minute reuses the same minute-stamped save_folder, so per-attempt
        # watcher state would re-report attempt 1's stall dumps as fresh
        # and instantly "stall"-kill every relaunch
        self._watchers: dict = {}
        # set by the SIGTERM/SIGINT handler: the supervisor itself is being
        # preempted and must RELAY the signal (the launchers exec this
        # process, so on a fleet it is what the scheduler terminates — the
        # default action would orphan the trainer with no grace window and
        # lose the emergency save the whole preempt contract promises)
        self._terminate: Optional[int] = None
        # last raw sidecar scrape (the straggler tracker reads the skew
        # gauges off the SAME scrape liveness used — one GET per poll)
        self._last_scrape: Optional[dict] = None
        # whether the last scrape answered (None before an attempt's first):
        # each change is recorded once, so a sidecar that never comes up,
        # or goes away, is on the timeline without one event a poll
        self._scrape_ok: Optional[bool] = None
        # per-boundary findings -> K-of-N persistence verdicts (the
        # tracker dedups scrapes of the same boundary internally, so the
        # supervisor timeline gets one finding per boundary, not per poll)
        self._straggler = observe.StragglerTracker(
            cfg.straggler_skew_secs,
            persist_k=cfg.straggler_persist_k,
            window_n=cfg.straggler_window_n,
            clock=clock,
        )
        # the verdict a mitigation preempt was issued for (None between),
        # read by run() into the ExitObservation; and the sticky rebalance
        # hint carried into every relaunch until cleared by a resize
        self._mitigation: Optional[dict] = None
        self._share: Optional[str] = None

    # ------------------------------------------------------------- channels
    def _handle_signal(self, signum, frame):  # noqa: ARG002 — handler signature
        self._terminate = signum

    def _discard_stale_resize(self) -> None:
        """Terminal exits (done/give_up/shutdown/launch failure) must not
        leave a pending resize_request behind: the next, unrelated
        supervised run in the same workdir would silently consume it at
        launch and boot on a topology requested for a finished job."""
        path = os.path.join(self.supervise_dir, RESIZE_REQUEST_FILE)
        if not os.path.exists(path):
            return
        try:
            os.remove(path)
        except OSError:
            return
        self.recorder.event("resize_request_discarded", track="supervisor")
        logger.warning(
            "discarding pending resize_request: the supervised run is over"
        )

    def _resize_requested(self) -> Optional[int]:
        """Consume ``<supervise_dir>/resize_request`` (one integer) if
        present; malformed content is logged and discarded — a typo must
        not wedge the supervisor."""
        path = os.path.join(self.supervise_dir, RESIZE_REQUEST_FILE)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                raw = f.read()
        except OSError as e:
            # transient read failure (NFS hiccup, permission blip): the
            # file is the operator's ONLY copy of the request — leave it
            # for the next poll rather than deleting intent we never read
            logger.warning("resize_request unreadable (%s); will retry", e)
            return None
        if not raw.strip():
            # empty = caught mid-write (`echo 4 > file` truncates before
            # writing): same retry treatment as unreadable — deleting here
            # would silently drop the request the poll raced
            return None
        try:
            devices = int(raw.strip())
        except ValueError:
            logger.warning("ignoring malformed %s: %r", path, raw[:80])
            devices = None
        try:
            os.remove(path)
        except OSError:
            pass
        if devices is not None and devices <= 0:
            logger.warning("ignoring non-positive resize request %r", devices)
            return None
        return devices

    def _liveness_age(self) -> Optional[float]:
        """``train_last_boundary_age_seconds`` from the child's sidecar, or
        None when unavailable (sidecar down/not up yet) or not yet beating
        (the gauge's -1 sentinel before the first flush boundary)."""
        if self.scraper is None:
            self._last_scrape = None
            return None
        gauges = self.scraper.scrape()
        self._last_scrape = gauges
        if (gauges is not None) != self._scrape_ok:
            self._scrape_ok = gauges is not None
            self.recorder.event("sidecar_scrape", track="supervisor", ok=self._scrape_ok,
                                url=getattr(self.scraper, "url", ""))
        if gauges is None:
            return None
        age = gauges.get("train_last_boundary_age_seconds")
        if age is None or age < 0:
            return None
        return age

    # ----------------------------------------------------------- bookkeeping
    def _record_decision(
        self, decision: policy.Decision, rc: int, stalled: bool
    ) -> None:
        """The one writer of the ``decision`` event schema (three exit
        paths share it — a hand-copied field drift would silently diverge
        the events.jsonl the gate and post-mortem tooling consume)."""
        self.decisions.append(decision)
        self.recorder.event(
            "decision", track="supervisor", action=decision.action,
            reason=decision.reason, rc=rc, stalled=stalled,
            delay_s=decision.delay_s, devices=decision.devices,
            share=decision.share, restarts=self.policy.restarts,
        )
        logger.warning(
            "supervise decision: %s (%s)", decision.action, decision.reason
        )

    def _sleep_interruptible(self, total_s: float) -> None:
        """Backoff sleep in poll-sized slices: PEP 475 restarts an
        interrupted sleep, so one long sleep would finish the whole backoff
        after a SIGTERM and relaunch a child just to kill it."""
        remaining = float(total_s)
        step = max(0.05, self.cfg.poll_s)
        while remaining > 0 and self._terminate is None:
            chunk = min(remaining, step)
            self._sleep(chunk)
            remaining -= chunk

    # ------------------------------------------------------------ one attempt
    def _watch_child(self):
        """Poll until the child exits or a liveness verdict kills it.
        Returns ``(returncode, stalled, stall_dumps, health_alarms)``.

        The run dir only exists once the child finalizes its config (and a
        relaunch may open a NEW timestamped dir), so each poll follows the
        newest run dir — through a per-dir watcher that is PERSISTENT
        across attempts (see ``_watchers``), so artifacts from an earlier
        attempt are never re-counted against the current child."""
        cfg = self.cfg
        stall_dumps = 0
        health_alarms = 0
        # the stall VERDICT only counts dumps written during THIS attempt
        # (wall-clock mtime — the dumps are disk artifacts): a dump left by
        # a previous supervisor SESSION is fresh to this process's watcher
        # state and would otherwise liveness-kill a healthy child on the
        # first poll. Older dumps are still recorded as observations.
        attempt_started = time.time()
        while True:
            rc = self.child.poll()
            run_dir = launch.find_resume_dir(
                cfg.workdir, exclude=self._run_dir_exclude
            ) or ""
            if run_dir not in self._watchers:
                self._watchers[run_dir] = observe.RunDirWatcher(run_dir)
                if run_dir:
                    self.recorder.event(
                        "run_dir_observed", track="supervisor", path=run_dir
                    )
            watcher = self._watchers[run_dir]
            dumps, events, ckpts = watcher.poll()
            fresh_dumps = []
            for path in dumps:
                try:
                    fresh = os.path.getmtime(path) >= attempt_started
                except OSError:
                    fresh = False
                if fresh:
                    fresh_dumps.append(path)
                    stall_dumps += 1
                self.recorder.event(
                    "stall_dump_observed", track="supervisor", path=path,
                    fresh=fresh,
                )
            for rec in events:
                if rec.get("name") == "health_alarm":
                    health_alarms += 1
                self.recorder.event(
                    "trainer_event", track="supervisor",
                    event=rec.get("name"), args=rec.get("args", {}),
                    file=rec.get("_file"),
                )
            for name in ckpts:
                self.recorder.event(
                    "checkpoint_observed", track="supervisor", ckpt=name
                )
            if rc is not None:
                return rc, False, stall_dumps, health_alarms
            if self._terminate is not None:
                # the supervisor itself is being preempted: relay through
                # the same grace escalation, so the trainer's preempt
                # machinery gets its emergency-save window (exit 75)
                self.recorder.event(
                    "supervisor_signal", track="supervisor",
                    signum=int(self._terminate),
                )
                logger.warning(
                    "supervisor received signal %d: relaying to child pid "
                    "%d (grace %gs)", self._terminate, self.child.pid,
                    cfg.grace_secs,
                )
                rc = self.child.terminate_gracefully(
                    cfg.grace_secs, sleep=self._sleep, clock=self._clock
                )
                return rc, False, stall_dumps, health_alarms
            resize = self._resize_requested()
            if resize is not None:
                self.policy.request_resize(resize)
                self.recorder.event(
                    "resize_request", track="supervisor", devices=resize
                )
                logger.warning(
                    "resize request to %d device(s): preempting the child "
                    "(grace %gs)", resize, cfg.grace_secs,
                )
                rc = self.child.terminate_gracefully(
                    cfg.grace_secs, sleep=self._sleep, clock=self._clock
                )
                return rc, False, stall_dumps, health_alarms
            age = self._liveness_age()
            finding = self._straggler.observe(self._last_scrape)
            if finding is not None:
                # one boundary's observation (the warn rung of the
                # ladder): recorded once per boundary step, not per poll
                self.recorder.event(
                    "straggler_finding", track="supervisor", **finding
                )
                logger.warning(
                    "straggler finding: boundary skew %.3fs >= %.3fs "
                    "(step %s, straggler %s)",
                    finding["skew_s"], finding["bar_s"],
                    finding.get("step"), finding.get("straggler"),
                )
            verdict = self._straggler.take_persistent()
            if verdict is not None:
                # K-of-N boundaries named the same host: a PERSISTENCE
                # verdict, always recorded. Mitigation only when enabled
                # AND no operator resize is pending (the explicit request
                # outranks the inferred remedy — the resize branch above
                # would already have preempted this poll anyway)
                self.recorder.event(
                    "straggler_persistent", track="supervisor",
                    mitigate=bool(cfg.straggler_mitigate), **verdict
                )
                if (cfg.straggler_mitigate
                        and self.policy.pending_resize is None):
                    self._mitigation = verdict
                    self.recorder.event(
                        "straggler_mitigation", track="supervisor",
                        phase="preempt", **verdict
                    )
                    logger.warning(
                        "persistent straggler host %s (%d/%d boundaries, "
                        "skew %.3fs): preempting for mitigation "
                        "(grace %gs)",
                        verdict.get("straggler"), verdict.get("votes", 0),
                        verdict.get("window", 0), verdict["skew_s"],
                        cfg.grace_secs,
                    )
                    rc = self.child.terminate_gracefully(
                        cfg.grace_secs, sleep=self._sleep, clock=self._clock
                    )
                    return rc, False, stall_dumps, health_alarms
                logger.warning(
                    "persistent straggler host %s (%d/%d boundaries, skew "
                    "%.3fs) — recorded, no action (mitigation %s)",
                    verdict.get("straggler"), verdict.get("votes", 0),
                    verdict.get("window", 0), verdict["skew_s"],
                    "off" if not cfg.straggler_mitigate
                    else "deferred to pending resize",
                )
            stalled = bool(
                cfg.stall_secs > 0
                and ((age is not None and age >= cfg.stall_secs)
                     or fresh_dumps)
            )
            if stalled:
                self.recorder.event(
                    "liveness_stall", track="supervisor",
                    age_s=age, stall_secs=cfg.stall_secs,
                    watchdog_dumps=stall_dumps,
                )
                logger.error(
                    "liveness stall (boundary age %s >= %gs or watchdog "
                    "dump): terminating child pid %d",
                    f"{age:.1f}" if age is not None else "n/a",
                    cfg.stall_secs, self.child.pid,
                )
                rc = self.child.terminate_gracefully(
                    cfg.grace_secs, sleep=self._sleep, clock=self._clock
                )
                return rc, True, stall_dumps, health_alarms
            self._sleep(cfg.poll_s)

    # ------------------------------------------------------------------ run
    def run(self) -> int:
        """Supervise to completion; returns the process exit code (0 done,
        else the final child's shell-normalized code)."""
        cfg = self.cfg
        devices = cfg.devices or None
        resume_dir: Optional[str] = None
        attempt = 0
        prev_handlers = {}
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[s] = signal.signal(s, self._handle_signal)
        except ValueError:
            # not the main thread (embedded/test use): no OS-level relay —
            # the _terminate flag can still be set programmatically
            prev_handlers = {}
        last_rc = 0
        try:
            while True:
                if self._terminate is not None:
                    # preempted between attempts (during backoff, or before
                    # the first launch): exit NOW — booting a child just to
                    # kill it would waste the scheduler's grace window
                    decision = policy.Decision(
                        policy.SHUTDOWN,
                        f"supervisor received signal {self._terminate} with "
                        f"no child running; exiting without relaunch",
                    )
                    self._record_decision(decision, last_rc, False)
                    self._discard_stale_resize()
                    return (
                        shell_code(last_rc) if attempt
                        else 128 + int(self._terminate)
                    )
                attempt += 1
                # a resize filed BETWEEN attempts (during backoff, or while
                # the supervisor was down) applies directly to this launch —
                # routing it through the kill path would boot a child on the
                # old topology only to preempt it immediately, burning one
                # restart-budget unit and a full startup on a routine
                # operator action
                resize = self._resize_requested()
                if resize is not None:
                    self.recorder.event(
                        "resize_request", track="supervisor", devices=resize,
                        applied="at_launch",
                    )
                    devices = resize
                try:
                    self.child = launch.Child(
                        cfg.command, resume_dir=resume_dir, devices=devices,
                        share=self._share,
                    )
                except OSError as e:
                    # an unlaunchable command (typo'd executable, EPERM) is
                    # permanent: retrying cannot help, and dying with a raw
                    # traceback would leave no decision on record — give up
                    # through the policy surface with the shell's 127
                    self.recorder.event(
                        "launch_failed", track="supervisor", attempt=attempt,
                        error=str(e), command=list(cfg.command),
                    )
                    self._record_decision(
                        policy.Decision(
                            policy.GIVE_UP,
                            f"training command failed to launch: {e}",
                        ),
                        127, False,
                    )
                    self._discard_stale_resize()
                    return 127
                self.recorder.event(
                    "launch", track="supervisor", attempt=attempt,
                    pid=self.child.pid, devices=devices,
                    share=self._share,
                    resume=resume_dir or "", command=self.child.command,
                )
                logger.info(
                    "supervise: attempt %d pid %d (devices=%s share=%s "
                    "resume=%s)",
                    attempt, self.child.pid, devices or "inherit",
                    self._share or "uniform", resume_dir or "none",
                )
                # fresh detection per attempt: the relaunch restarts its
                # gauge stream, and stale votes must not convict it
                self._straggler.reset()
                self._scrape_ok = None
                self._mitigation = None
                start = self._clock()
                rc, stalled, dumps, alarms = self._watch_child()
                last_rc = rc
                self.recorder.record_span(
                    "child_run", track="supervisor", start=start,
                    end=self._clock(), attempt=attempt, rc=rc,
                    stalled=stalled,
                )
                if self._terminate is not None:
                    # our own preemption, relayed: never relaunch (the
                    # scheduler wants us GONE), exit with the child's code
                    # so an outer orchestrator sees 75 when the save landed
                    self._record_decision(
                        policy.Decision(
                            policy.SHUTDOWN,
                            f"supervisor received signal {self._terminate}: "
                            f"relayed to the child (exit {rc}); not "
                            f"relaunching",
                        ),
                        rc, False,
                    )
                    self._discard_stale_resize()
                    return shell_code(rc)
                mit = self._mitigation
                obs = policy.ExitObservation(
                    returncode=rc, stalled=stalled,
                    stall_dumps=dumps, health_alarms=alarms,
                    straggler_persistent=mit is not None,
                    straggler_host=int(mit.get("straggler", -1))
                    if mit else -1,
                    straggler_skew_s=float(mit.get("skew_s", 0.0))
                    if mit else 0.0,
                    processes=int(mit.get("processes", 0)) if mit else 0,
                )
                decision = self.policy.decide(obs)
                self._record_decision(decision, rc, stalled)
                if mit is not None:
                    # close the mitigation span on the timeline: what the
                    # preempt actually bought (a ladder rung, or give_up)
                    self.recorder.event(
                        "straggler_mitigation", track="supervisor",
                        phase="decided", action=decision.action,
                        share=decision.share, devices=decision.devices,
                        host=obs.straggler_host,
                    )
                if decision.action == policy.DONE:
                    self._discard_stale_resize()
                    return 0
                if decision.action == policy.GIVE_UP:
                    self._discard_stale_resize()
                    return shell_code(rc)
                if decision.delay_s > 0:
                    self._sleep_interruptible(decision.delay_s)
                if decision.devices is not None:
                    devices = decision.devices
                if decision.action == policy.RESTART_REBALANCED:
                    self._share = decision.share
                elif decision.action == policy.RESTART_RESIZED:
                    # exclusion (or an operator resize): shares are
                    # uniform again across the new topology — a stale
                    # hint would starve a host that is no longer slow
                    self._share = None
                # require_checkpoint: only inject --resume when a COMPLETE
                # save exists somewhere — an empty newest dir (child died
                # before its first save) would fail resolve_resume_path on
                # every retry; a fresh start is the correct fallback
                resume_dir = launch.find_resume_dir(
                    cfg.workdir, exclude=self._run_dir_exclude,
                    require_checkpoint=True,
                )
        finally:
            for s, h in prev_handlers.items():
                try:
                    signal.signal(s, h)
                except ValueError:  # pragma: no cover — teardown edge
                    pass
            self.recorder.close()
