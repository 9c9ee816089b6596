"""Signal collection for the supervisor: scraping and run-folder watching
(the port's copy of JAX ``supervise/observe.py``).

Three channels, all on the host, all read-only against the trainer:

- :class:`MetricsScraper`: HTTP GET against the trainer's ``--metrics_port``
  sidecar (``utils/prom.py``) with :func:`parse_prometheus_text`, the
  inverse of ``render_prometheus`` for the unlabeled gauge lines the
  sidecar serves. ``train_last_boundary_age_seconds`` is the liveness
  signal; the scraper never raises (a dead sidecar is itself an
  observation, returned as None).
- :class:`RunDirWatcher`: incremental polling of the trainer's run folder
  for what the observability layer leaves there: stall-watchdog dumps
  (``stall_dump_N.txt``), ``health_alarm`` / ``nan_rollback`` /
  ``preempt_exit`` / ``stall_detected`` records appended to the recorder's
  ``events*.jsonl`` (read from a remembered offset: the files are
  append-only), and new checkpoints: a ``*.pth`` that loads (the port's
  saves are written to a temporary name and renamed, and a torn file is
  never reported). Each ``poll()`` returns only what is new since the
  last, so the supervisor's own recorder logs each artifact once.
- exit codes arrive through ``subprocess`` and are classified by
  :mod:`supervise.policy`; nothing to collect here.

Nothing in ``supervise/`` touches the card: the supervisor is a host
process, and the accelerator belongs to its child.
"""

from __future__ import annotations

import glob
import os
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import readable_checkpoint
# the one torn-line-tolerant jsonl reader
from simclr_pytorch_distributed_tpu_torch.utils.tracing import parse_jsonl

# recorder event names the watcher surfaces to the supervisor (the trainer
# emits them on its side: utils/guard.py HealthMonitor, train/*.py,
# utils/tracing.StallWatchdog)
WATCHED_EVENTS = ("health_alarm", "nan_rollback", "preempt_exit", "stall_detected")


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Unlabeled ``name value`` lines -> dict; labeled/histogram series and
    comment lines are skipped (the trainer sidecar emits only plain gauges;
    tolerating the rest keeps the parser usable against the serve server's
    richer exposition too)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "{" in line:
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


class MetricsScraper:
    """GET /metrics against the trainer sidecar; ``scrape()`` returns the
    gauge dict or None (connection refused, timeout, bad body — a dead or
    not-yet-up sidecar is an observation, not an error). ``opener`` is
    injectable for the no-network unit tests."""

    def __init__(
        self, port: int, host: str = "127.0.0.1", timeout_s: float = 2.0,
        opener=None,
    ):
        self.url = f"http://{host}:{port}/metrics"
        self.timeout_s = timeout_s
        self._opener = opener if opener is not None else self._http_get

    def _http_get(self) -> str:
        with urllib.request.urlopen(self.url, timeout=self.timeout_s) as r:
            return r.read().decode()

    def scrape(self) -> Optional[Dict[str, float]]:
        try:
            return parse_prometheus_text(self._opener())
        except (OSError, urllib.error.URLError, ValueError):
            return None


# the fleet-skew gauges the trainer sidecar exposes: utils/telemetry.py
# stamps them at each flush boundary's failure-code all-gather (the skew is
# the spread of the per-process waits that ride that collective; the
# straggler gauge is argmin(wait), the process everyone else waited on,
# and process_count is the fleet size that wait vector came from)
SKEW_GAUGE = "train_boundary_skew_seconds"
WAIT_GAUGE = "train_collective_wait_seconds"
STRAGGLER_GAUGE = "train_boundary_straggler"
PROC_COUNT_GAUGE = "train_process_count"


def straggler_finding(
    gauges: Optional[Dict[str, float]], skew_bar_s: float
) -> Optional[dict]:
    """One boundary's straggler observation from one sidecar scrape, or None.

    Fires when ``train_boundary_skew_seconds`` (the fleet's boundary
    arrival spread) is at/above ``skew_bar_s``: some process is late to
    the collectives and the whole synchronous step is paced by it. One
    finding is one BOUNDARY, not a verdict: transient skew (a GC pause, a
    noisy neighbor) is normal, so acting on a single finding would thrash.
    :class:`StragglerTracker` folds the per-boundary findings into a
    K-of-N persistence verdict, and the policy ladder
    (supervise/policy.py: warn -> restart_rebalanced -> restart_resized ->
    give_up) acts on THAT.

    Beyond the skew itself the finding carries the REBALANCE CONTEXT when
    the sidecar exposes it: ``straggler`` — which
    process the fleet waited on (``train_boundary_straggler``, -1/absent
    on a single process); ``processes`` — the fleet size; and ``share`` —
    the straggler's current per-process share of the global batch
    (``1/processes``; data/pipeline.EpochLoader slices uniform contiguous
    blocks), the quantity a ``restart_rebalanced`` decision shrinks.
    Against an older sidecar without those gauges the finding still fires
    but carries no identity — enough to warn, not enough to mitigate."""
    if not gauges or skew_bar_s <= 0:
        return None
    skew = gauges.get(SKEW_GAUGE)
    if skew is None or skew < skew_bar_s:
        return None
    finding = {"skew_s": skew, "bar_s": skew_bar_s}
    for key, name in ((WAIT_GAUGE, "wait_s"), ("train_step", "step")):
        if key in gauges:
            finding[name] = gauges[key]
    straggler = gauges.get(STRAGGLER_GAUGE)
    if straggler is not None and straggler >= 0:
        finding["straggler"] = int(straggler)
    processes = gauges.get(PROC_COUNT_GAUGE)
    if processes is not None and processes > 0:
        finding["processes"] = int(processes)
        finding["share"] = 1.0 / int(processes)
    return finding


# sentinel: "no boundary deduped yet" (train_step may legitimately be
# absent from a scrape — a None step must still dedup correctly)
_NO_STEP = object()


class StragglerTracker:
    """Per-boundary straggler findings -> a K-of-N PERSISTENCE verdict.

    ``observe(gauges)`` is fed every scrape; it returns the boundary's
    finding exactly once per boundary (the skew gauge holds its value
    between flush boundaries, so scrapes are deduplicated on the
    ``train_step`` gauge) and maintains a sliding window of the last
    ``window_n`` boundaries. A straggler is declared PERSISTENT — exposed
    by :meth:`take_persistent` — only when at least ``persist_k`` of those
    boundaries named the SAME host above the bar. That hysteresis is the
    point: one boundary of skew (a GC pause, a checkpoint fsync, a noisy
    neighbor burst) never triggers, and a straggler identity that hops
    between hosts (load imbalance, not a sick host) never accumulates K
    votes for any one of them.

    Single-process runs are ALWAYS benign: without the identity gauges
    (``train_boundary_straggler`` >= 0 and ``train_process_count`` > 1)
    a boundary contributes no vote — there is no host to rebalance away
    from, and utils/telemetry.py publishes zero skew anyway.

    ``clock`` is injectable (the supervisor passes its own): verdict
    timestamps come from it, never from ``time`` directly, so the loop
    tests drive the tracker without real waiting. ``take_persistent``
    consumes the verdict and resets the window — the supervisor acts once
    per verdict (or records it once, in warn-only mode), and detection
    starts fresh for the next attempt via :meth:`reset`.
    """

    def __init__(
        self,
        skew_bar_s: float,
        persist_k: int = 3,
        window_n: int = 5,
        clock=None,
    ):
        if persist_k < 1:
            raise ValueError(f"persist_k must be >= 1, got {persist_k}")
        if window_n < persist_k:
            raise ValueError(
                f"need window_n >= persist_k, got {window_n}/{persist_k}"
            )
        self.skew_bar_s = float(skew_bar_s)
        self.persist_k = int(persist_k)
        self.window_n = int(window_n)
        self._clock = clock if clock is not None else (lambda: 0.0)
        # sliding window of (straggler-or-None, finding) per NEW boundary
        self._window: List[tuple] = []
        self._last_step: object = _NO_STEP
        self._persistent: Optional[dict] = None

    def reset(self) -> None:
        """Fresh window + step dedup (a new child attempt restarts its
        gauge stream; stale votes must not convict the relaunch)."""
        self._window = []
        self._last_step = _NO_STEP
        self._persistent = None

    def observe(self, gauges: Optional[Dict[str, float]]) -> Optional[dict]:
        """Feed one scrape; returns the finding when this scrape is a NEW
        boundary at/above the bar (for the supervisor to record), else
        None. Below-bar boundaries still enter the window — they dilute
        the vote, which is how a recovered host walks itself back out."""
        if not gauges or self.skew_bar_s <= 0:
            return None
        step = gauges.get("train_step")
        if step == self._last_step:
            return None  # same boundary; the gauge holds between beats
        self._last_step = step
        finding = straggler_finding(gauges, self.skew_bar_s)
        host = finding.get("straggler") if finding else None
        multi = (gauges.get(PROC_COUNT_GAUGE) or 0) > 1
        vote = host if (finding is not None and host is not None and multi) else None
        self._window.append((vote, finding))
        if len(self._window) > self.window_n:
            self._window.pop(0)
        if vote is not None:
            votes = sum(1 for v, _ in self._window if v == vote)
            if votes >= self.persist_k:
                self._persistent = dict(
                    finding, votes=votes, window=len(self._window),
                    at=self._clock(),
                )
        return finding

    def take_persistent(self) -> Optional[dict]:
        """The pending persistence verdict (finding + ``votes``/``window``/
        ``at``), or None; consuming it resets the window."""
        verdict = self._persistent
        if verdict is not None:
            self.reset()
        return verdict


class RunDirWatcher:
    """Incremental view of one trainer run dir.

    ``poll()`` returns ``(stall_dumps, events, checkpoints)`` — only items
    NEW since the previous poll:

    - ``stall_dumps``: paths of fresh ``stall_dump_N.txt`` files (the
      watchdog's artifact — its presence is a liveness verdict from INSIDE
      the process, complementing the scraper's outside view);
    - ``events``: recorder records from every ``events*.jsonl`` in the dir
      whose ``name`` is in :data:`WATCHED_EVENTS` (per-session ``_rK`` and
      per-process ``_pN`` suffixes included — resumes open new files);
    - ``checkpoints``: names of ``*.pth`` files that were written since
      the last poll and load (progress evidence: a supervisor post-mortem
      shows what was SAVED between decisions, not just what failed). A
      rewritten file (``last.pth`` each epoch) is new again; a file that
      does not load yet, a torn write, is not reported and is read again
      at the next poll.

    The run dir may not exist yet (the child creates it after parsing its
    configuration) — polls before that return empty results.
    """

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        # path -> mtime: a RELAUNCHED trainer restarts its watchdog counter
        # at 1 and overwrites stall_dump_1.txt in the (reused) run dir, so
        # path identity alone would hide every stall after the first — a
        # changed mtime makes an overwritten dump new again
        self._seen_dumps: Dict[str, float] = {}
        self._offsets: Dict[str, int] = {}   # events file -> bytes consumed
        self._seen_ckpts: Dict[str, float] = {}  # .pth path -> mtime reported

    def _new_events(self) -> List[dict]:
        events: List[dict] = []
        for path in sorted(glob.glob(os.path.join(self.run_dir, "events*.jsonl"))):
            offset = self._offsets.get(path, 0)
            try:
                with open(path) as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            # only consume COMPLETE lines: the trainer appends+flushes per
            # record, but a poll can still race the write mid-line
            # (tracing.parse_jsonl, also behind utils/trace_report.py)
            records, consumed = parse_jsonl(chunk)
            self._offsets[path] = offset + consumed
            for rec in records:
                if rec.get("name") in WATCHED_EVENTS:
                    rec["_file"] = os.path.basename(path)
                    events.append(rec)
        return events

    def poll(self) -> Tuple[List[str], List[dict], List[str]]:
        if not os.path.isdir(self.run_dir):
            return [], [], []
        dumps = []
        for p in sorted(glob.glob(os.path.join(self.run_dir, "stall_dump_*.txt"))):
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if self._seen_dumps.get(p) != mtime:
                self._seen_dumps[p] = mtime
                dumps.append(p)
        ckpts = []
        for path in sorted(glob.glob(os.path.join(self.run_dir, "*.pth"))):
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if self._seen_ckpts.get(path) == mtime or readable_checkpoint(path) is None:
                continue
            self._seen_ckpts[path] = mtime
            ckpts.append(os.path.basename(path))
        return dumps, self._new_events(), ckpts
