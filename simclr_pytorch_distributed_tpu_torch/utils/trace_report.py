"""Per-phase step-time attribution and the fleet view from the flight
recorder's ``events*.jsonl`` (the port's copy of JAX
``scripts/trace_report.py``; ``scripts/port_trace_report.py`` is its CLI).

The recorder (``utils/tracing.py``) instruments only host-visible
boundaries, and its ``main:*`` phase tracks never nest across each other,
so summing their span durations partitions the run's measured wall clock:

    wall = compile + data + flush + checkpoint + collective + ...
           + steady_state (the remainder: the dispatch-only hot loop)

:func:`build_report` builds that table with anomaly flags (compile-heavy
runs, flush-heavy windows, data stalls, recorded stall, rollback and
preemption events) and a consistency bit: phases non-negative and not
overlapping, the table summing to the wall time.

The fleet view (:func:`build_fleet_report`) reads a data-parallel run's
folder, where each process writes ``events_pN.jsonl`` on its own
monotonic clock: it finds every session's per-process files
(``tracing.discover_fleet_sessions``), aligns the timelines through the
``clock_anchor`` events each process stamps at matched collective points
(an affine fit per process, with its residual checked against
:data:`FLEET_RESIDUAL_TOL_S`), and gives a per-collective skew table
naming the straggler at each boundary (arrival = the ``main:collective``
span's start), a straggler ranking, per-process attribution checks, and
the merged Chrome trace (``pid`` = process index).

    python scripts/port_trace_report.py --events <run_dir>/events.jsonl [--json out.json]
    python scripts/port_trace_report.py --fleet <run_dir> [--json out.json] [--trace merged.json]
"""

import argparse
import json
import os

from simclr_pytorch_distributed_tpu_torch.utils import tracing
from simclr_pytorch_distributed_tpu_torch.utils.tracing import (
    ANCHOR_EVENT,
    EPOCH_TRACK,
    MAIN_TRACK_PREFIX,
    chrome_trace_from_events,
)

SCHEMA = "trace_report/v1"
FLEET_SCHEMA = "fleet_report/v1"
COLLECTIVE_TRACK = "main:collective"
# max acceptable affine-fit residual: the anchors are post-release stamps
# of one physical instant, so after the per-process affine map they must
# agree to within collective release jitter (ms-scale even on a loaded
# CPU host; a residual past this means the merge cannot be trusted)
FLEET_RESIDUAL_TOL_S = 0.25

# advisory share thresholds per phase (fraction of wall): above them the
# phase is flagged — not an error, a "look here first" pointer
ANOMALY_SHARES = {
    "compile": 0.50,   # cold compile dominating: check the compile cache
    "data": 0.35,      # window staging not hidden by prefetch
    "flush": 0.25,     # telemetry flush on the critical path: check async
    "checkpoint": 0.25,  # save serialization/commit stalling the loop
    "eval": 0.60,      # validation dwarfing training (tiny-epoch smokes)
}
# recorded events that are findings in themselves
EVENT_FLAGS = {
    "stall_detected": "stall watchdog fired (see stall_dump_* artifacts)",
    "nan_rollback": "NaN rollback(s) recorded",
    "preempt_exit": "run ended by preemption",
    "flush_failure": "telemetry flush failure observed",
    "recorder_dropped": "flight-recorder ring saturated: trace.json and "
                        "watchdog snapshots truncated (events.jsonl is "
                        "complete)",
}
# span overlap tolerance (s): clock reads bracketing a record are not atomic
OVERLAP_TOL_S = 1e-4


def load_events(path):
    """One session's records through the torn-line-tolerant loader
    (``tracing.parse_jsonl``): the half-written last line a SIGKILL leaves
    is exactly the run this report exists to diagnose."""
    return tracing.load_events_jsonl(path)


def _attributed_tracks(events):
    tracks = {}
    for e in events:
        track = e.get("track", "")
        if (
            e.get("ph") == "X"
            and track.startswith(MAIN_TRACK_PREFIX)
            and track != EPOCH_TRACK
        ):
            tracks.setdefault(track, []).append(e)
    return tracks


def build_report(events):
    """The attribution report (pure: the tests drive it on synthetic event
    lists)."""
    if not events:
        raise ValueError("no events: recorder off or empty run?")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in events)
    wall = t1 - t0

    tracks = _attributed_tracks(events)
    phases = {}
    spans = []
    monotone_ok = True
    for track, track_events in sorted(tracks.items()):
        track_events.sort(key=lambda e: e["ts"])
        prev_end = None
        durs = [e.get("dur", 0.0) for e in track_events]
        for e in track_events:
            if prev_end is not None and e["ts"] < prev_end - OVERLAP_TOL_S:
                monotone_ok = False
            prev_end = e["ts"] + e.get("dur", 0.0)
            spans.append((e["ts"], prev_end))
        phases[track[len(MAIN_TRACK_PREFIX):]] = {
            "seconds": round(sum(durs), 6),
            "count": len(durs),
            "mean_ms": round(1e3 * sum(durs) / len(durs), 3),
            "max_ms": round(1e3 * max(durs), 3),
        }
    # the cross-track invariant that makes the table sum to wall: all
    # attributed spans live on the main thread, so they must be globally
    # non-overlapping, not just per track
    spans.sort()
    for (s0, e0), (s1, _) in zip(spans, spans[1:]):
        if s1 < e0 - OVERLAP_TOL_S:
            monotone_ok = False

    attributed = sum(p["seconds"] for p in phases.values())
    steady = wall - attributed
    for name, p in phases.items():
        p["share"] = round(p["seconds"] / wall, 4) if wall > 0 else 0.0

    anomalies = []
    for name, p in phases.items():
        bar = ANOMALY_SHARES.get(name)
        if bar is not None and p["share"] > bar:
            anomalies.append({
                "phase": name,
                "flag": f"share {p['share']:.0%} > {bar:.0%}",
            })
    event_counts = {}
    for e in events:
        if e.get("ph") == "i" and e["name"] in EVENT_FLAGS:
            event_counts[e["name"]] = event_counts.get(e["name"], 0) + 1
    for name, count in sorted(event_counts.items()):
        anomalies.append({
            "phase": "events", "flag": f"{EVENT_FLAGS[name]} (x{count})",
        })

    nonnegative_ok = steady >= -OVERLAP_TOL_S
    return {
        "phases": phases,
        "steady_state": {
            "seconds": round(steady, 6),
            "share": round(steady / wall, 4) if wall > 0 else 0.0,
        },
        "anomalies": anomalies,
        "consistency": {
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "steady_state_s": round(steady, 6),
            "monotone_ok": monotone_ok,
            "nonnegative_ok": bool(nonnegative_ok),
            # the gate bit: the table sums to the measured wall time (exact
            # by construction) AND that construction was valid — attributed
            # spans non-overlapping and the remainder non-negative
            "ok": bool(monotone_ok and nonnegative_ok and wall > 0),
        },
        "n_events": len(events),
    }


def render_table(report):
    rows = [("phase", "seconds", "share", "count", "mean_ms", "max_ms")]
    for name, p in sorted(
        report["phases"].items(), key=lambda kv: -kv[1]["seconds"]
    ):
        rows.append((
            name, f"{p['seconds']:.3f}", f"{p['share']:.1%}",
            str(p["count"]), f"{p['mean_ms']:.1f}", f"{p['max_ms']:.1f}",
        ))
    ss = report["steady_state"]
    rows.append((
        "steady_state", f"{ss['seconds']:.3f}", f"{ss['share']:.1%}",
        "-", "-", "-",
    ))
    rows.append((
        "wall", f"{report['consistency']['wall_s']:.3f}", "100.0%",
        "-", "-", "-",
    ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths))
        for row in rows
    ]
    lines.insert(1, "-" * len(lines[0]))
    for a in report["anomalies"]:
        lines.append(f"ANOMALY [{a['phase']}]: {a['flag']}")
    if not report["consistency"]["ok"]:
        lines.append("CONSISTENCY: FAILED (overlapping or oversubscribed "
                     "attribution — recorder track contract violated)")
    return "\n".join(lines)


def build_output(events_path, report):
    """The report's JSON artifact (pure)."""
    return {"schema": SCHEMA, "events": events_path, "report": report}


# ------------------------------------------------------------------ fleet


def anchor_points(events):
    """``{anchor_seq: local_ts}`` of one process's clock anchors."""
    out = {}
    for e in events:
        if e.get("name") == ANCHOR_EVENT and e.get("ph") == "i":
            args = e.get("args", {})
            if "anchor" in args:
                out[int(args["anchor"])] = float(e["ts"])
    return out


def fit_alignment(ref_anchors, anchors):
    """Affine map local -> reference clock over the matched anchor seqs
    (pure). Least squares over >=2 anchors recovers offset AND rate drift;
    one anchor degrades to offset-only (scale pinned at 1); zero matched
    anchors means the timelines cannot be merged (``residual_s`` None).
    ``residual_s`` is the MAX absolute fit error — the merge's error bar,
    gated against :data:`FLEET_RESIDUAL_TOL_S`."""
    seqs = sorted(set(ref_anchors) & set(anchors))
    n = len(seqs)
    if n == 0:
        return {"scale": 1.0, "offset_s": 0.0, "residual_s": None,
                "n_anchors": 0}
    xs = [anchors[s] for s in seqs]
    ys = [ref_anchors[s] for s in seqs]
    if n == 1:
        a, b = 1.0, ys[0] - xs[0]
    else:
        mx, my = sum(xs) / n, sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        a = sxy / sxx if sxx > 0 else 1.0
        b = my - a * mx
    residual = max(abs(a * x + b - y) for x, y in zip(xs, ys))
    return {"scale": a, "offset_s": round(b, 6),
            "residual_s": round(residual, 6), "n_anchors": n}


def _aligned(alignment, ts):
    return alignment["scale"] * ts + alignment["offset_s"]


def build_fleet_report(events_by_process, residual_tol_s=FLEET_RESIDUAL_TOL_S):
    """One session's merged fleet view (pure — tests drive it on synthetic
    per-process event lists).

    ``events_by_process`` maps process index -> that process's records.
    The lowest process index is the reference clock; every other process
    is affine-fitted onto it through the matched ``clock_anchor`` events.
    Collective spans (``main:collective``) are matched across processes by
    (name, per-process occurrence index) — valid because the collective
    call SCHEDULE is identical across processes (the repo's documented
    deadlock invariant); a span's start is that process's ARRIVAL at the
    boundary, so the aligned arrival spread is the boundary's skew and the
    latest arrival is its straggler.
    """
    if not events_by_process:
        raise ValueError("no per-process event lists: empty fleet?")
    pids = sorted(events_by_process)
    ref = pids[0]
    anchors = {p: anchor_points(events_by_process[p]) for p in pids}
    alignments = {
        p: fit_alignment(anchors[ref], anchors[p]) for p in pids
    }

    processes = {}
    attribution_ok = True
    for p in pids:
        try:
            rep = build_report(events_by_process[p])
            ok = bool(rep["consistency"]["ok"])
        except ValueError:
            ok = False
        attribution_ok = attribution_ok and ok
        processes[str(p)] = {
            "n_events": len(events_by_process[p]),
            "n_anchors": len(anchors[p]),
            "alignment": alignments[p],
            "attribution_ok": ok,
        }

    # collective spans, grouped by (name, occurrence) across processes;
    # skew is a CROSS-process spread, so a single-process merge has no
    # skew table (not a table of zeros)
    groups = {}
    for p in (pids if len(pids) > 1 else ()):
        counters = {}
        for e in events_by_process[p]:
            if e.get("ph") == "X" and e.get("track") == COLLECTIVE_TRACK:
                i = counters.get(e["name"], 0)
                counters[e["name"]] = i + 1
                groups.setdefault((e["name"], i), {})[p] = {
                    "arrival": _aligned(alignments[p], e["ts"]),
                    "wait_s": e.get("dur", 0.0),
                    "step": e.get("args", {}).get("step"),
                }
    skew_table = []
    incomplete = 0
    times_last = {p: 0 for p in pids}
    lateness = {p: [] for p in pids}
    for (name, i), by_p in groups.items():
        if set(by_p) != set(pids):
            # a process died (or went silent) before this boundary: real
            # finding on a preempted run, merge-contract violation on a
            # clean one — counted either way, skewless
            incomplete += 1
            continue
        arrivals = {p: by_p[p]["arrival"] for p in pids}
        first = min(arrivals.values())
        straggler = max(pids, key=lambda p: arrivals[p])
        for p in pids:
            lateness[p].append(arrivals[p] - first)
        times_last[straggler] += 1
        skew_table.append({
            "name": name, "index": i, "step": by_p[ref]["step"],
            "t_s": round(first, 6),
            "skew_s": round(arrivals[straggler] - first, 6),
            "straggler": straggler,
            "arrivals_s": {str(p): round(arrivals[p], 6) for p in pids},
        })
    skew_table.sort(key=lambda r: r["t_s"])
    ranking = sorted(
        (
            {
                "process": p,
                "times_last": times_last[p],
                "boundaries": len(lateness[p]),
                "mean_lateness_s": round(
                    sum(lateness[p]) / len(lateness[p]), 6
                ) if lateness[p] else 0.0,
            }
            for p in pids
        ),
        key=lambda r: (-r["times_last"], -r["mean_lateness_s"]),
    )

    non_ref = pids[1:]
    residuals = [alignments[p]["residual_s"] for p in non_ref]
    aligned_ok = all(
        alignments[p]["n_anchors"] >= 2
        and alignments[p]["residual_s"] is not None
        and alignments[p]["residual_s"] <= residual_tol_s
        for p in non_ref
    )
    collective_match_ok = incomplete == 0
    consistency = {
        "n_processes": len(pids),
        "aligned_ok": bool(aligned_ok),
        "max_residual_s": max([r for r in residuals if r is not None],
                              default=0.0),
        "residual_tol_s": residual_tol_s,
        "attribution_ok": bool(attribution_ok),
        "collective_match_ok": bool(collective_match_ok),
        "incomplete_boundaries": incomplete,
        # the gate bit: timelines really merged (every non-ref process
        # anchored to sub-tolerance), every per-process attribution holds,
        # every collective boundary is whole, and a multi-process merge
        # produced at least one skew observation (none = the fleet
        # instrumentation was silently dead)
        "ok": bool(
            aligned_ok and attribution_ok and collective_match_ok
            and (len(pids) == 1 or len(skew_table) > 0)
        ),
    }
    return {
        "processes": processes,
        "skew_table": skew_table,
        "straggler_ranking": ranking,
        "consistency": consistency,
    }


def fleet_chrome_trace(events_by_process, report):
    """The merged Chrome trace: every process's records mapped onto the
    reference clock (its fitted alignment), ``pid`` = process index, the
    whole fleet shifted so the earliest record sits at t=0 (Chrome/Perfetto
    dislike negative timestamps)."""
    aligned = {}
    t0 = None
    for p, events in sorted(events_by_process.items()):
        al = report["processes"][str(p)]["alignment"]
        evs = []
        for e in events:
            e2 = dict(e, ts=_aligned(al, e["ts"]))
            if "dur" in e2:
                e2["dur"] = e2["dur"] * al["scale"]
            evs.append(e2)
            t0 = e2["ts"] if t0 is None else min(t0, e2["ts"])
        aligned[p] = evs
    out = {"traceEvents": [], "displayTimeUnit": "ms"}
    for p, evs in sorted(aligned.items()):
        trace = chrome_trace_from_events(
            [dict(e, ts=e["ts"] - t0) for e in evs], process_index=p
        )
        out["traceEvents"].extend(trace["traceEvents"])
    return out


def render_fleet_table(report, max_rows=12):
    lines = []
    rows = [("process", "events", "anchors", "scale", "offset_s",
             "residual_s", "attribution")]
    for p, info in sorted(report["processes"].items(), key=lambda kv: int(kv[0])):
        al = info["alignment"]
        res = al["residual_s"]
        rows.append((
            p, str(info["n_events"]), str(info["n_anchors"]),
            f"{al['scale']:.9g}", f"{al['offset_s']:.6f}",
            "-" if res is None else f"{res:.6f}",
            "ok" if info["attribution_ok"] else "FAILED",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    table = sorted(report["skew_table"], key=lambda r: -r["skew_s"])[:max_rows]
    if table:
        lines.append(f"boundary skew (top {len(table)} by skew):")
        for r in table:
            lines.append(
                f"  {r['name']}[{r['index']}] step={r['step']} "
                f"t={r['t_s']:.3f}s skew={r['skew_s'] * 1e3:.1f}ms "
                f"straggler=p{r['straggler']}"
            )
    for r in report["straggler_ranking"]:
        if r["boundaries"]:
            lines.append(
                f"straggler ranking: p{r['process']} last at "
                f"{r['times_last']}/{r['boundaries']} boundaries "
                f"(mean lateness {r['mean_lateness_s'] * 1e3:.1f}ms)"
            )
    cons = report["consistency"]
    if not cons["ok"]:
        lines.append(f"CONSISTENCY: FAILED ({cons})")
    return "\n".join(lines)


def build_fleet_output(run_dir, session_reports):
    """The fleet report's JSON artifact (pure): one report per recorder
    session, ``ok`` = every session merged consistently."""
    return {
        "schema": FLEET_SCHEMA,
        "run_dir": run_dir,
        "sessions": session_reports,
        "ok": bool(session_reports) and all(
            rep["consistency"]["ok"] for rep in session_reports.values()
        ),
    }


def run_fleet(args):
    sessions = tracing.discover_fleet_sessions(args.fleet)
    if not sessions:
        print(f"no events*.jsonl sessions in {args.fleet}")
        return 1
    reports = {}
    last = None
    for label, files in sessions.items():
        # EVERY discovered process file enters the merge, records or not: a
        # process whose file exists but holds zero complete records (a
        # SIGKILL before its first full line) is exactly the dead-process
        # post-mortem this mode exists to surface — silently dropping it
        # would let a 2-process session merge "consistently" as one
        events_by_process = {
            pidx: load_events(path) for pidx, path in sorted(files.items())
        }
        report = build_fleet_report(events_by_process)
        report["files"] = {
            str(p): os.path.basename(files[p]) for p in events_by_process
        }
        reports[label] = report
        last = (events_by_process, report)
        print(f"== session {label} "
              f"({report['consistency']['n_processes']} process(es)) ==")
        print(render_fleet_table(report))
    artifact = build_fleet_output(args.fleet, reports)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.json}")
    if args.trace and last is not None:
        # the merged Chrome trace of the LATEST session (the one a
        # post-mortem usually wants — earlier sessions stay per-process)
        with open(args.trace, "w") as f:
            json.dump(fleet_chrome_trace(*last), f)
        print(f"wrote {args.trace}")
    return 0 if artifact["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="flight-recorder attribution and fleet report (utils/trace_report.py)")
    ap.add_argument("--events", default="",
                    help="a flight-recorder events.jsonl (run dir artifact)")
    ap.add_argument("--fleet", default="", metavar="RUN_DIR",
                    help="fleet mode: merge every per-process "
                         "events*_p*.jsonl session in this run dir "
                         "(clock-anchor alignment, skew table, straggler "
                         "ranking)")
    ap.add_argument("--json", default="",
                    help="write the attribution/fleet artifact here")
    ap.add_argument("--trace", default="",
                    help="(fleet) write the merged Chrome trace here")
    args = ap.parse_args(argv)
    if bool(args.events) == bool(args.fleet):
        ap.error("exactly one of --events / --fleet is required")

    if args.fleet:
        return run_fleet(args)
    report = build_report(load_events(args.events))
    print(render_table(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(build_output(args.events, report), f, indent=1)
        print(f"wrote {args.json}")
    return 0 if report["consistency"]["ok"] else 1


