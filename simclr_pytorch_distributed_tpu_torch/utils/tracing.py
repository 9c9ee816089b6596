"""Flight recorder: span/event tracing and the stall watchdog.

The port's own copy of the JAX package's ``utils/tracing.py`` (host-only:
it imports neither JAX nor torch at module scope).

- :class:`FlightRecorder`: a thread-safe span/event recorder with an
  injectable monotonic clock, appending one JSON line per record to a
  per-run ``events.jsonl`` and exporting a Chrome-trace/Perfetto-loadable
  ``trace.json`` on close. Only host-visible boundaries are instrumented
  (flush boundaries, checkpoint commits, collective decisions, epoch
  edges, validation), so the hot loop gains no device sync and no
  transfer.
- :class:`StallWatchdog`: a background thread that fires when the
  progress beat (the drivers' flush boundary) has not advanced within a
  deadline, dumping every thread's stack via ``faulthandler`` and a
  recorder snapshot into the run folder, so a wedged collective or device
  leaves an artifact instead of a silent hang.

Track convention: spans on ``main:*`` tracks are main-thread phases that
never nest across tracks, so they partition the epoch loop's wall clock.
``main:epoch`` is the one exception, an envelope around the others. Tracks
owned by other threads (``telemetry:*``) carry no such invariant.

The module-level ``install``/``span``/``event`` helpers follow the
``logging`` pattern: instrumentation sites call ``tracing.span(...)``
unconditionally and pay a global read and a no-op context manager when no
recorder is installed.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

# main-thread phase tracks: the non-nesting attribution convention above
MAIN_TRACK_PREFIX = "main:"
# the envelope track excluded from attribution (it CONTAINS the others)
EPOCH_TRACK = "main:epoch"
# the fleet track: clock anchors + per-boundary skew observations, the
# records a multi-process timeline is aligned on
FLEET_TRACK = "fleet"
ANCHOR_EVENT = "clock_anchor"



class FlightRecorder:
    """Thread-safe span/event recorder behind one lock.

    Records live in a bounded in-memory ring (``snapshot`` — what the
    watchdog dumps) and, when ``path`` is given, are appended to an
    ``events.jsonl`` file as they land. ``clock`` must be monotonic;
    timestamps are stored relative to construction time, so records from
    different processes align only per-file (one recorder per process,
    ``recorder_for_run``).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        max_events: int = 65536,
        trace_path: Optional[str] = None,
        process_index: int = 0,
    ):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max_events)
        self._path = path
        self._trace_path = trace_path
        self._file = None
        self._closed = False
        self.process_index = int(process_index)
        self.dropped = 0  # records lost to the ring bound (jsonl keeps all)
        self._anchor_seq = 0  # clock_anchor sequence (see clock_anchor)

    # ------------------------------------------------------------ record
    def _emit(self, rec: dict) -> None:
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._closed:
                return
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
            if self._path is not None:
                if self._file is None:
                    self._file = open(self._path, "a")
                self._file.write(line + "\n")
                # flush every record: a flight recorder exists for the runs
                # that DON'T exit cleanly (SIGKILL after the grace window, a
                # wedged collective) — a userspace buffer would lose exactly
                # the last, most interesting records. Records land only at
                # host boundaries (a few per window / per request), so the
                # per-record flush is noise there; no fsync — surviving a
                # kernel crash is not the contract.
                self._file.flush()

    def now(self) -> float:
        """The recorder's clock (absolute; records store ``now() - t0``)."""
        return self._clock()

    def event(self, name: str, track: str = "events", **attrs) -> None:
        """An instantaneous event (Chrome ``ph: "i"``)."""
        rec = {
            "name": name, "track": track, "ph": "i",
            "ts": round(self._clock() - self._t0, 6),
        }
        if attrs:
            rec["args"] = attrs
        self._emit(rec)

    def clock_anchor(self, kind: str, **attrs) -> int:
        """Record a fleet clock anchor and return its sequence number.

        Anchors are stamped at already-matched collective points (each
        flush boundary's failure-code all-gather) right after the
        collective releases: every process leaves it at about the same real
        instant, so anchor ``seq`` k is the same physical moment observed
        through each process's unaligned monotonic clock, and the
        per-process ``(seq, ts)`` pairs are an alignment ruler for merging
        the timelines. The sequence is deterministic because the
        collective call schedule is (a mismatched count is already a
        deadlock).
        Single-process runs record the same events (host-only, zero device
        cost); they simply carry no cross-process information.
        """
        with self._lock:
            self._anchor_seq += 1
            seq = self._anchor_seq
        self.event(ANCHOR_EVENT, track=FLEET_TRACK, kind=kind, anchor=seq,
                   **attrs)
        return seq

    def record_span(
        self, name: str, track: str, start: float, end: float, **attrs
    ) -> None:
        """A completed span from explicit clock values.

        ``start``/``end`` must come from THIS recorder's clock domain
        (``now()`` or the same injected clock): a span stamped on one
        thread can be recorded on another.
        """
        rec = {
            "name": name, "track": track, "ph": "X",
            "ts": round(start - self._t0, 6),
            "dur": round(max(0.0, end - start), 6),
        }
        if attrs:
            rec["args"] = attrs
        self._emit(rec)

    @contextlib.contextmanager
    def span(self, name: str, track: str, **attrs):
        start = self._clock()
        try:
            yield
        finally:
            self.record_span(name, track, start, self._clock(), **attrs)

    # ------------------------------------------------------------ output
    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """The most recent records (all, or the last ``last``) — what the
        watchdog attaches to a stall dump."""
        with self._lock:
            records = list(self._ring)
        return records if last is None else records[-last:]

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """The Chrome-trace/Perfetto view of the in-memory ring; written to
        ``path`` (or the constructor's ``trace_path``) when given."""
        trace = chrome_trace_from_events(
            self.snapshot(), process_index=self.process_index
        )
        path = path or self._trace_path
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        return trace

    def close(self) -> None:
        """Flush the jsonl, export ``trace.json`` (when configured), and
        stop accepting records. Never raises — it runs in driver
        ``finally`` blocks where a raise would mask the real failure."""
        with self._lock:
            if self._closed:
                return
        if self.dropped:
            # a saturated ring means trace.json and watchdog snapshots are
            # truncated (the jsonl keeps everything): leave the count on
            # the durable record so trace_report can flag it as a finding
            self.event(
                "recorder_dropped", track="events", records=self.dropped
            )
        try:
            self.export_chrome_trace()
        except OSError as e:  # disk full on the way out: keep the exit clean
            logger.warning("flight recorder: trace export failed (%s)", e)
        with self._lock:
            self._closed = True
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def chrome_trace_from_events(events: Iterable[dict], process_index: int = 0) -> dict:
    """Chrome trace-event JSON from recorder records (pure; the JAX
    package's schema). Tracks map to integer ``tid``s with
    ``thread_name`` metadata; ``ts``/``dur`` are integer microseconds."""
    tids: dict = {}
    out = []
    for rec in events:
        track = rec.get("track", "events")
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
        ev = {
            "name": rec["name"],
            "ph": "X" if rec.get("ph") == "X" else "i",
            "pid": process_index,
            "tid": tid,
            "ts": int(round(rec["ts"] * 1e6)),
            "args": rec.get("args", {}),
        }
        if ev["ph"] == "X":
            ev["dur"] = int(round(rec.get("dur", 0.0) * 1e6))
        else:
            ev["s"] = "t"  # instant-event scope: thread
        out.append(ev)
    meta = [
        {
            "name": "thread_name", "ph": "M", "pid": process_index, "tid": tid,
            "args": {"name": track},
        }
        for track, tid in tids.items()
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


EVENTS_FILE = "events.jsonl"
TRACE_FILE = "trace.json"

# events[_pN][_rK].jsonl: process N (absent = 0), session K (absent = 1), the
# names run_paths gives
EVENTS_FILE_RE = re.compile(r"^(events(?:_p(\d+))?)(?:_r(\d+))?\.jsonl$")


def parse_jsonl(text: str) -> Tuple[List[dict], int]:
    """Recorder jsonl text as ``(records, consumed)`` (JAX
    ``utils/tracing.py:283``).

    The one reader behind :func:`load_events_jsonl`, the trace report
    (``utils/trace_report.py``) and the supervisor's ``RunDirWatcher``:
    only complete lines, through the last newline, are read, so the
    half-written last line a SIGKILL (or a reader racing the writer) leaves
    never breaks the reader; a complete line that does not parse is
    skipped. ``consumed`` is the offset just past the last newline, where
    an incremental reader resumes."""
    consumed = text.rfind("\n") + 1
    records: List[dict] = []
    for line in text[:consumed].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records, consumed


def load_events_jsonl(path: str) -> List[dict]:
    """Every complete record of one recorder jsonl."""
    with open(path) as f:
        return parse_jsonl(f.read())[0]


def session_files_for(events_path: str) -> List[str]:
    """Every session file of the process ``events_path`` belongs to, in
    session order: ``events.jsonl``, ``events_r2.jsonl``, ... (or the
    ``events_pN*`` family). A resumed run opens a new ``_rK`` file each
    session (:func:`run_paths`), so a reader that stops at the first file
    loses the timeline after the first preemption. A name outside the
    pattern returns itself."""
    d, fname = os.path.split(events_path)
    m = EVENTS_FILE_RE.match(fname)
    if not m:
        return [events_path]
    base = m.group(1)
    out = []
    k = 1
    while True:
        name = f"{base}.jsonl" if k == 1 else f"{base}_r{k}.jsonl"
        path = os.path.join(d, name)
        if not os.path.exists(path):
            break
        out.append(path)
        k += 1
    return out or [events_path]


def discover_fleet_sessions(run_dir: str) -> Dict[str, Dict[int, str]]:
    """Every recorder session of a run folder, grouped for the fleet view:
    ``{"r1": {0: ".../events.jsonl", 1: ".../events_p1.jsonl"}, "r2":
    ...}``, process index to its events file. Timestamps restart each
    session, so a session aligns only with itself."""
    sessions: Dict[int, Dict[int, str]] = {}
    for fname in sorted(os.listdir(run_dir)):
        m = EVENTS_FILE_RE.match(fname)
        if not m:
            continue
        pidx = int(m.group(2) or 0)
        k = int(m.group(3) or 1)
        sessions.setdefault(k, {})[pidx] = os.path.join(run_dir, fname)
    return {f"r{k}": files for k, files in sorted(sessions.items())}


def run_paths(run_dir: str, process_index: int = 0):
    """Per-process, per-SESSION recorder file names inside one (shared)
    run dir.

    Timestamps are relative to each recorder's construction, so a resumed
    run (the exit-75 relaunch loop lands in the SAME save_folder) must not
    append a second ts~0 timeline into the first session's file — that
    would read as overlapping main-thread spans and fail trace_report's
    attribution on exactly the preempted runs the recorder exists to
    diagnose. Each session therefore gets the first unused ``_rK`` suffix:
    ``events.jsonl``, ``events_r2.jsonl``, ... (and the matching
    ``trace*.json``), one self-consistent timeline per file.
    """
    base = "events" if process_index == 0 else f"events_p{process_index}"
    tbase = "trace" if process_index == 0 else f"trace_p{process_index}"
    session = ""
    k = 1
    while os.path.exists(os.path.join(run_dir, f"{base}{session}.jsonl")):
        k += 1
        session = f"_r{k}"
    return (
        os.path.join(run_dir, f"{base}{session}.jsonl"),
        os.path.join(run_dir, f"{tbase}{session}.json"),
    )


def recorder_for_run(
    run_dir: str, enabled: bool = True, clock: Callable[[], float] = time.monotonic
) -> Optional[FlightRecorder]:
    """The drivers' one-call recorder factory: ``events.jsonl`` +
    ``trace.json`` in the run dir, with per-process suffixes under a
    process group (every process keeps its own story) and per-session
    suffixes across resumes (:func:`run_paths`). The process index is
    ``torch.distributed.get_rank()`` when a process group is up, else 0."""
    if not enabled or not run_dir:
        return None
    pidx = process_index()
    os.makedirs(run_dir, exist_ok=True)
    events, trace = run_paths(run_dir, pidx)
    return FlightRecorder(
        events, clock=clock, trace_path=trace, process_index=pidx
    )


def process_index() -> int:
    """This process's rank in the process group, 0 without one."""
    import torch.distributed as dist  # lazy: the module stays host-only

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# ---------------------------------------------------------------- current
# logging-style module-level recorder: instrumentation sites stay one-line
# and cost a global read when no recorder is installed.

_current: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder]) -> None:
    global _current
    _current = recorder


def uninstall() -> None:
    install(None)


def current() -> Optional[FlightRecorder]:
    return _current


@contextlib.contextmanager
def span(name: str, track: str, **attrs):
    rec = _current
    if rec is None:
        yield
        return
    with rec.span(name, track, **attrs):
        yield


def event(name: str, track: str = "events", **attrs) -> None:
    rec = _current
    if rec is not None:
        rec.event(name, track, **attrs)


def clock_anchor(kind: str, **attrs) -> Optional[int]:
    """Record a fleet clock anchor on the installed recorder (no-op
    ``None`` without one) — see :meth:`FlightRecorder.clock_anchor`."""
    rec = _current
    if rec is None:
        return None
    return rec.clock_anchor(kind, **attrs)


def record_span(name: str, track: str, start: float, end: float, **attrs) -> None:
    rec = _current
    if rec is not None:
        rec.record_span(name, track, start, end, **attrs)


# ---------------------------------------------------------------- watchdog


class StallWatchdog:
    """Fires when the progress beat hasn't advanced within ``deadline_s``.

    The drivers beat at every ``print_freq`` flush boundary (wired through
    ``TelemetrySession``): exactly the points whose silence means a stalled collective,
    a wedged device, or a deadlocked pipeline. On fire it writes two
    artifacts into ``dump_dir``:

    - ``stall_dump_N.txt`` — every thread's Python stack
      (``faulthandler.dump_traceback``), i.e. WHERE each host thread is
      blocked (the collective call, the queue wait, the D2H);
    - ``stall_dump_N.json`` — the stall metadata plus a
      :class:`FlightRecorder` snapshot (what the run was doing on the way
      in), when a recorder is attached.

    One dump per stall: after firing it stays quiet until a beat re-arms
    it. ``check()`` is the testable core — the fake-clock tier-1 tests
    drive it directly (``start=False``), the background thread merely calls
    it on a real-time cadence. The watchdog only OBSERVES (no recovery
    action): killing or resuming a wedged collective from a watchdog thread
    would trade a diagnosable hang for corrupted state.
    """

    def __init__(
        self,
        deadline_s: float,
        dump_dir: str,
        clock: Callable[[], float] = time.monotonic,
        recorder: Optional[FlightRecorder] = None,
        poll_s: Optional[float] = None,
        start: bool = True,
        name: str = "train",
        armed: bool = True,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir
        self.name = name
        self._clock = clock
        self._recorder = recorder
        self._lock = threading.Lock()
        self._last = clock()
        self._armed = bool(armed)
        self._fired = False
        self.dumps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            # real-time polling cadence; staleness itself is judged against
            # the injectable clock, so tests never depend on this thread
            self._poll_s = poll_s if poll_s is not None else max(
                1.0, self.deadline_s / 4.0
            )
            self._thread = threading.Thread(
                target=self._run, name=f"stall-watchdog-{name}", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check()

    # ------------------------------------------------------------- beats
    def beat(self) -> None:
        """Progress observed: reset the deadline and re-arm the next dump."""
        with self._lock:
            self._last = self._clock()
            self._fired = False

    def arm(self) -> None:
        """Start watching (beats first — arming is itself progress)."""
        with self._lock:
            self._last = self._clock()
            self._fired = False
            self._armed = True

    def disarm(self) -> None:
        """Stop watching (silence is expected, not a stall)."""
        with self._lock:
            self._armed = False

    # ------------------------------------------------------------- check
    def check(self) -> bool:
        """Evaluate the deadline now; returns True iff a dump was written
        by THIS call."""
        with self._lock:
            if not self._armed or self._fired:
                return False
            age = self._clock() - self._last
            if age <= self.deadline_s:
                return False
            self._fired = True
            self.dumps += 1
            n = self.dumps
        self._dump(age, n)
        return True

    def _dump(self, age: float, n: int) -> None:
        txt_path = os.path.join(self.dump_dir, f"stall_dump_{n}.txt")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(txt_path, "w") as f:
                f.write(
                    f"STALL: {self.name} progress beat stalled for "
                    f"{age:.1f}s (deadline {self.deadline_s:.1f}s); "
                    f"all thread stacks follow\n"
                )
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
        except OSError as e:  # the watchdog must never kill the run
            logger.error("stall watchdog: stack dump failed (%s)", e)
        if self._recorder is not None:
            self._recorder.event(
                "stall_detected", track="watchdog", age_s=round(age, 3),
                deadline_s=self.deadline_s, dump=n,
            )
            self._recorder.flush()
            json_path = os.path.join(self.dump_dir, f"stall_dump_{n}.json")
            try:
                with open(json_path, "w") as f:
                    json.dump(
                        {
                            "name": self.name,
                            "age_s": round(age, 3),
                            "deadline_s": self.deadline_s,
                            "dump": n,
                            "events": self._recorder.snapshot(last=512),
                        },
                        f, default=str,
                    )
            except OSError as e:
                logger.error("stall watchdog: snapshot dump failed (%s)", e)
        logger.error(
            "STALL: %s progress beat stalled for %.1fs (deadline %.1fs); "
            "thread stacks dumped to %s", self.name, age, self.deadline_s,
            txt_path,
        )

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
