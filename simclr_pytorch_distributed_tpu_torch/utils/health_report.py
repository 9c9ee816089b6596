"""The per-run training-health timeline and its findings, read from the
flight recorder's ``events.jsonl`` (the port's copy of JAX
``scripts/health_report.py``; ``scripts/port_health_report.py`` is its
CLI).

The step writes the representation diagnostics (``health_*``) and, with
``--online_probe on``, the probe's columns into the metric ring; at each
flush the health monitor (``utils/guard.HealthMonitor``) writes one
``health_window`` event of the window's means on the ``health`` track and
a ``health_alarm`` event for each verdict. The recorder's jsonl is then
the run's durable health stream, and this module its offline reader:
:func:`build_report` rebuilds the timeline, each metric's first, last,
smallest and largest window, the online probe's trajectory, the findings
(alarms, the collapse signature of the last window, and the guard events
that are findings in themselves) and a consistency bit (a non-empty,
monotone timeline whose every window carries :data:`REQUIRED_HEALTH_KEYS`:
the diagnostics really streamed through the ring to the recorder).

The collapse signature's bars are the live monitor's own
(``utils/guard.thresholds_for_recipe``), chosen by the recipe that the
driver's ``run_recipe`` event records (or ``--recipe``), so the offline
reader reaches the verdict the live monitor would. Plain Python and json:
nothing here needs torch or a device.

    python scripts/port_health_report.py --events <run_dir>/events.jsonl [--json out.json]

Exits 0 when the stream is consistent, else 1.
"""

import argparse
import json
import os

from simclr_pytorch_distributed_tpu_torch.utils import tracing
from simclr_pytorch_distributed_tpu_torch.utils.guard import (
    RECIPE_HEALTH_THRESHOLDS,
    thresholds_for_recipe,
)

SCHEMA = "health_report/v1"

# every health_window event carries these: the step's health columns
# (train/supcon_step.HEALTH_METRIC_KEYS; the ring's columns are fixed per
# run, so a missing key means the stream was torn or written by another tool)
REQUIRED_HEALTH_KEYS = (
    "health_align", "health_con_top1", "health_eff_rank",
    "health_grad_norm", "health_neg_max", "health_neg_mean", "health_unif",
)

# guard events that are findings in themselves (the trace report's convention)
EVENT_FLAGS = {
    "health_alarm": "collapse/divergence detector fired",
    "stall_detected": "stall watchdog fired (see stall_dump_* artifacts)",
    "nan_rollback": "NaN rollback(s) recorded",
    "preempt_exit": "run ended by preemption",
    "flush_failure": "telemetry flush failure observed",
}


def recipe_from_events(events):
    """The run's recipe as the driver's ``run_recipe`` event records it, or
    ``None`` for a stream without one (the probe and CE trainers)."""
    for e in events:
        if e.get("name") == "run_recipe":
            return e.get("args", {}).get("recipe")
    return None


def session_paths(path):
    """The files one ``--events`` argument selects. A base session file
    (``events.jsonl``, ``events_pN.jsonl``) expands to its process's whole
    session family: a resumed run in the same folder writes
    ``events_r2.jsonl``, ``events_r3.jsonl``, ... (``tracing.run_paths``),
    and the first file alone would cut the timeline at the first
    preemption. An explicit rotated file (``events_r2.jsonl``) selects that
    session alone."""
    m = tracing.EVENTS_FILE_RE.match(os.path.basename(path))
    if m and not m.group(3):
        return tracing.session_files_for(path)
    return [path]


def load_events(path):
    """The selected sessions' records in session order
    (:func:`session_paths`), each file through the torn-line-tolerant
    loader (``tracing.load_events_jsonl``). The windows key on the global
    step, which a resume restores, so the concatenation stays monotone."""
    events = []
    for session_path in session_paths(path):
        events.extend(tracing.load_events_jsonl(session_path))
    return events


def build_report(events, recipe=None):
    """The health report of ``events`` (pure). ``recipe`` overrides the
    recipe the stream records; the resolved name picks the collapse
    signature's bars (``utils/guard.thresholds_for_recipe``)."""
    if not events:
        raise ValueError("no events: recorder off or empty run?")
    recipe = recipe if recipe is not None else recipe_from_events(events)
    bars = thresholds_for_recipe(recipe)
    windows = [e.get("args", {}) for e in events
               if e.get("name") == "health_window" and e.get("track") == "health"]
    timeline = [w for w in windows if "step" in w]
    steps = [int(w["step"]) for w in timeline]
    keys = sorted(set().union(*(w.keys() for w in timeline)) - {"step"}) if timeline else []

    series = {}
    for k in keys:
        nums = [float(w[k]) for w in timeline if k in w]
        series[k] = {"first": nums[0], "last": nums[-1], "min": min(nums), "max": max(nums),
                     "n": len(nums)}

    findings = []
    alarms = [dict(e.get("args", {}), name=e["name"]) for e in events
              if e.get("name") == "health_alarm"]
    event_counts = {}
    for e in events:
        if e.get("ph") == "i" and e.get("name") in EVENT_FLAGS:
            event_counts[e["name"]] = event_counts.get(e["name"], 0) + 1
    for name, count in sorted(event_counts.items()):
        findings.append({"kind": name, "flag": f"{EVENT_FLAGS[name]} (x{count})"})
    if timeline:
        last = timeline[-1]
        if float(last.get("health_eff_rank", float("inf"))) < bars.eff_rank_min:
            findings.append({
                "kind": "collapse_signature",
                "flag": f"final-window effective rank {last['health_eff_rank']:.3g} < "
                        f"{bars.eff_rank_min:g}" + (f" (recipe {recipe} bar)" if recipe else ""),
            })
        if (float(last.get("health_align", 0.0)) > bars.align_max
                and float(last.get("health_neg_mean", 0.0)) > bars.neg_mean_max):
            findings.append({"kind": "collapse_signature",
                             "flag": "final-window positives AND negatives ~1"})

    probe = None
    if any(k.startswith("probe_") for k in keys):
        probe = {
            "first_top1": series["probe_top1"]["first"],
            "last_top1": series["probe_top1"]["last"],
            "best_top1": series["probe_top1"]["max"],
            "windows": series["probe_top1"]["n"],
        }

    if timeline:
        missing = sorted(k for k in REQUIRED_HEALTH_KEYS if any(k not in w for w in timeline))
    else:
        missing = list(REQUIRED_HEALTH_KEYS)
    monotone_ok = all(a <= b for a, b in zip(steps, steps[1:]))
    consistency = {
        "n_windows": len(timeline),
        "monotone_ok": bool(monotone_ok),
        "missing_keys": missing,
        # the gate bit: the diagnostics streamed through the ring to the recorder
        "ok": bool(timeline) and monotone_ok and not missing,
    }
    return {
        "timeline": timeline,
        "series": series,
        "probe": probe,
        "alarms": alarms,
        "findings": findings,
        "consistency": consistency,
        "n_events": len(events),
        # the verdict's provenance: which recipe's bars judged the stream
        "recipe": recipe,
        "thresholds": {
            "eff_rank_min": bars.eff_rank_min,
            "align_max": bars.align_max,
            "neg_mean_max": bars.neg_mean_max,
        },
    }


def render_table(report):
    """The report as text: the series table, the findings, the probe line,
    and a line naming a failed consistency check."""
    lines = []
    rows = [("metric", "first", "last", "min", "max", "n")]
    for name, s in sorted(report["series"].items()):
        rows.append((name, f"{s['first']:.4g}", f"{s['last']:.4g}", f"{s['min']:.4g}",
                     f"{s['max']:.4g}", str(s["n"])))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines += ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)) for row in rows]
    if len(lines) > 1:
        lines.insert(1, "-" * len(lines[0]))
    for f in report["findings"]:
        lines.append(f"FINDING [{f['kind']}]: {f['flag']}")
    if report["probe"]:
        p = report["probe"]
        lines.append(f"online probe top-1: {p['first_top1']:.2f} -> {p['last_top1']:.2f} "
                     f"(best {p['best_top1']:.2f} over {p['windows']} windows)")
    if not report["consistency"]["ok"]:
        lines.append("CONSISTENCY: FAILED (empty/torn/non-monotone health stream: "
                     f"{report['consistency']})")
    return "\n".join(lines)


def build_output(events_path, report, device, session_files=None):
    """The report's artifact (pure). ``device`` is where the run that wrote
    the stream trained (``cuda`` or ``cpu``): the ``health_report`` gate
    (``scripts/port_ratchet.py``) binds its probe bar on the CPU only.
    ``session_files`` names the files read (a base ``--events`` expands to
    its session family)."""
    out = {"schema": SCHEMA, "events": events_path, "device": device, "report": report}
    if session_files is not None:
        out["session_files"] = [os.path.basename(p) for p in session_files]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="training-health timeline from a flight-recorder events.jsonl "
                    "(utils/health_report.py)")
    ap.add_argument("--events", required=True,
                    help="a flight-recorder events.jsonl (run dir artifact)")
    ap.add_argument("--json", default="", help="write the health-report artifact here")
    ap.add_argument("--recipe", default=None,
                    help="override the recorded recipe when selecting the per-recipe "
                         "collapse-signature bars (default: the stream's run_recipe event)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the run that wrote the stream trained, recorded in the "
                         "artifact (default cuda, the trainers' default)")
    args = ap.parse_args(argv)
    # a mistyped override would judge the stream by the default bars while
    # naming the bogus recipe as the verdict's provenance
    if args.recipe is not None and args.recipe not in RECIPE_HEALTH_THRESHOLDS:
        ap.error(f"--recipe {args.recipe!r} is not a known recipe "
                 f"(choose from {sorted(RECIPE_HEALTH_THRESHOLDS)})")
    report = build_report(load_events(args.events), recipe=args.recipe)
    print(render_table(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(build_output(args.events, report, args.device,
                                   session_files=session_paths(args.events)), f, indent=1)
        print(f"wrote {args.json}")
    return 0 if report["consistency"]["ok"] else 1
