"""Non-finite-loss detection, the failure policy, representation health
and the drivers' typed exit codes (JAX ``utils/guard.py``).

A non-finite loss seen by the telemetry flush (``utils/telemetry.py``, at
most one ``print_freq`` window after the step) raises
:class:`NonFiniteLossError`; the pretrain driver then saves
``crash_epoch_N.pth`` from the epoch-top state (``--nan_guard``) and asks
its :class:`FailurePolicy` (``--nan_policy``) what to do: ``abort`` exits
1; ``rollback`` restores the epoch-top state, skips the epoch and damps the
learning rate by :data:`ROLLBACK_LR_MULT`, at most :data:`MAX_ROLLBACKS`
times, after which it exits 1 too. ``main()`` runs through
:func:`exit_with_code`:

- 0: a clean run;
- 1 (:data:`EXIT_NONFINITE`): a non-finite loss;
- 2 (:data:`EXIT_FLUSH`): a telemetry flush failed for another reason
  (``utils/telemetry.TelemetryFlushError``);
- 3 (:data:`EXIT_HEALTH`): ``--health_policy abort`` and a collapsed or
  diverging representation (:class:`RepresentationHealthError`);
- 75 (``utils/preempt.EXIT_PREEMPTED``): preempted, state saved;
- any other exception propagates (the interpreter's 1).

When several failures land in one window, the flush boundary's collective
failure code decides, with the JAX package's precedence: health 3 > flush
2 > NaN 1. In a data-parallel run the loss is the global batch's, the same
on every process, and the code is reduced over the processes, so every
process leaves at the same boundary through the same exception.

Representation health (``--health_policy``): :class:`HealthMonitor`
evaluates the windowed diagnostics (``train/supcon_step.HEALTH_METRIC_KEYS``)
the metric ring delivers at each flush and turns a collapsed or diverging
representation, which a finite loss hides, into flight-recorder events
(``warn``) or a :class:`RepresentationHealthError` (``abort``). A health
abort is never rolled back: collapse lives in the weights.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque

from simclr_pytorch_distributed_tpu_torch.utils import tracing

EXIT_NONFINITE = 1  # NonFiniteLossError under --nan_policy abort
EXIT_FLUSH = 2  # TelemetryFlushError (a flush failure other than NaN)
EXIT_HEALTH = 3  # RepresentationHealthError under --health_policy abort

# each rollback halves the learning rate, at most three times (JAX
# utils/guard.py:47-49)
ROLLBACK_LR_MULT = 0.5
MAX_ROLLBACKS = 3


class NonFiniteLossError(RuntimeError):
    """Raised when the training loss goes NaN or Inf."""

    def __init__(self, loss: float, step: int):
        super().__init__(
            f"non-finite loss {loss!r} at global step {step}; aborting "
            "(an emergency checkpoint of the last epoch top is saved)"
        )
        self.loss = loss
        self.step = step


def check_finite_loss(loss: float, step: int, enabled: bool = True) -> None:
    if enabled and not math.isfinite(loss):
        raise NonFiniteLossError(loss, step)


class FailurePolicy:
    """What a :class:`NonFiniteLossError` does to the run (JAX
    ``utils/guard.py:132-162``). One per run; ``rollbacks`` and ``lr_scale``
    are run state that every checkpoint carries, so a resumed run keeps
    its damping and its remaining budget."""

    def __init__(self, policy: str = "abort"):
        if policy not in ("abort", "rollback"):
            raise ValueError(f"unknown nan_policy {policy!r}")
        self.policy = policy
        self.rollbacks = 0
        self.lr_scale = 1.0

    def should_rollback(self) -> bool:
        """True: restore the backup and go on, with the rollback booked (the
        count and the damping). False: abort."""
        if self.policy != "rollback" or self.rollbacks >= MAX_ROLLBACKS:
            return False
        self.rollbacks += 1
        self.lr_scale *= ROLLBACK_LR_MULT
        return True


def exit_code_for(exc: "BaseException | None") -> int:
    """The exit code for an exception leaving a driver's ``run()``:
    ``None`` -> 0, ``SystemExit`` its own code,
    :class:`RepresentationHealthError` -> 3, ``TelemetryFlushError`` -> 2,
    :class:`NonFiniteLossError` -> 1, anything else 1 (a plain crash)."""
    if exc is None:
        return 0
    if isinstance(exc, SystemExit):
        code = exc.code
        if code is None:
            return 0
        return code if isinstance(code, int) else 1
    from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetryFlushError

    if isinstance(exc, RepresentationHealthError):
        return EXIT_HEALTH
    if isinstance(exc, TelemetryFlushError):
        return EXIT_FLUSH
    if isinstance(exc, NonFiniteLossError):
        return EXIT_NONFINITE
    return 1


def exit_with_code(run_fn):
    """The drivers' ``main()`` epilogue: return ``run_fn()``'s value, turn
    a typed failure into ``SystemExit`` with its code (traceback logged),
    and let everything else (``SystemExit(75)``, real bugs) propagate."""
    from simclr_pytorch_distributed_tpu_torch.utils.telemetry import TelemetryFlushError

    try:
        return run_fn()
    except (RepresentationHealthError, TelemetryFlushError, NonFiniteLossError) as e:
        logging.exception("typed failure abort (exit code %d)", exit_code_for(e))
        raise SystemExit(exit_code_for(e)) from e


# health samples the detector's rolling window holds: at the default
# health_freq 10 about 80 steps, so one odd batch cannot trip a verdict
HEALTH_WINDOW = 8


class RepresentationHealthError(RuntimeError):
    """Raised (under ``--health_policy abort``) when the windowed
    representation diagnostics say the run is collapsed or diverging."""

    def __init__(self, findings, step: int):
        findings = list(findings)
        super().__init__(
            f"representation health alarm at global step {step}: " + "; ".join(findings)
        )
        self.findings = findings
        self.step = step


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Detector bars over windowed means (:class:`HealthMonitor`). A
    collapsed representation sits at eff_rank 1 and align = neg_mean = 1,
    while a random-init encoder already spreads to eff_rank >> 2, so the
    defaults fire on the degenerate regime only. ``grad_norm_max`` is off
    (0) by default: healthy gradient scales are recipe-specific."""

    eff_rank_min: float = 2.0
    align_max: float = 0.995
    neg_mean_max: float = 0.995
    grad_norm_max: float = 0.0
    min_samples: int = 2


# Per-recipe detector bars (JAX utils/guard.py:209-227). The contrastive
# recipes keep the defaults: their loss repels negatives, so only the fully
# degenerate regime should fire. The negative-free recipes (BYOL, SimSiam)
# are the runs where collapse is the failure the recipe's asymmetry exists
# to prevent, so the effective-rank bar is raised: an ablated predictor
# (--byol_predictor none) must trip it. Healthy negative-free runs drive
# alignment toward 1, so the align bar stays paired with neg_mean. VICReg's
# variance hinge fights collapse in the loss: the defaults apply.
RECIPE_HEALTH_THRESHOLDS = {
    "supcon": HealthThresholds(),
    "simclr": HealthThresholds(),
    "byol": HealthThresholds(eff_rank_min=3.0),
    "simsiam": HealthThresholds(eff_rank_min=3.0),
    "vicreg": HealthThresholds(),
}


def thresholds_for_recipe(recipe) -> HealthThresholds:
    """The detector bars for a recipe name; an unknown name or ``None``
    (the probe and CE trainers) gets the defaults."""
    return RECIPE_HEALTH_THRESHOLDS.get(recipe, HealthThresholds())


class HealthMonitor:
    """Windowed collapse/divergence detector over the ring's health samples
    (JAX ``utils/guard.py:238``).

    The drivers' flush job feeds it every fetched row (:meth:`ingest`, on
    the telemetry thread): rows whose health columns are all NaN (the
    sentinel of a step that is not a health step) are skipped, real samples
    enter a rolling window, and the window means are held against
    :class:`HealthThresholds`. Each ingest with new samples emits a
    ``health_window`` event (the means) on the ``health`` track; a verdict
    also emits ``health_alarm`` and, under ``policy='abort'``, raises
    :class:`RepresentationHealthError`, which the flush boundary's
    collective check re-raises on every process as failure code 3.
    Host-only: no device sync, no transfer.
    """

    def __init__(self, policy: str = "warn", thresholds: HealthThresholds = None,
                 window: int = HEALTH_WINDOW, extra_keys=()):
        if policy not in ("warn", "abort"):
            raise ValueError(f"unknown health_policy {policy!r}")
        self.policy = policy
        self.thresholds = thresholds if thresholds is not None else HealthThresholds()
        self.extra_keys = tuple(extra_keys)
        self._window: "deque[dict]" = deque(maxlen=window)
        self.samples = 0
        self.alarms = 0
        self.last_means: dict = {}
        # non-finite values inside real samples ({key: count}): a hard
        # divergence signal, surfaced once at the next evaluation
        self.nonfinite_keys: dict = {}
        self._nonfinite_surfaced = 0

    def observe(self, metrics: dict, step: int) -> bool:
        """Ingest one fetched ring row; True iff it carried a real health
        sample."""
        sample = {
            k: float(v) for k, v in metrics.items()
            if k.startswith(("health_", "probe_")) or k in self.extra_keys
        }
        health_vals = [v for k, v in sample.items() if k.startswith("health_")]
        if not health_vals or all(math.isnan(v) for v in health_vals):
            return False
        for k, v in sample.items():
            if not math.isfinite(v):
                self.nonfinite_keys[k] = self.nonfinite_keys.get(k, 0) + 1
        sample["step"] = int(step)
        self._window.append(sample)
        self.samples += 1
        return True

    def window_means(self) -> dict:
        """Mean of each finite metric over the rolling window (``step`` is
        the window's last step)."""
        if not self._window:
            return {}
        keys = set().union(*(s.keys() for s in self._window)) - {"step"}
        means = {}
        for k in sorted(keys):
            vals = [s[k] for s in self._window if k in s and math.isfinite(s[k])]
            if vals:
                means[k] = sum(vals) / len(vals)
        means["step"] = self._window[-1]["step"]
        return means

    def verdicts(self, means: dict):
        """The findings for one window-mean dict (pure)."""
        t = self.thresholds
        findings = []
        eff = means.get("health_eff_rank")
        if eff is not None and eff < t.eff_rank_min:
            findings.append(
                f"collapse: embedding effective rank {eff:.3g} < {t.eff_rank_min:g}"
            )
        align = means.get("health_align")
        neg = means.get("health_neg_mean")
        if (align is not None and neg is not None
                and align > t.align_max and neg > t.neg_mean_max):
            findings.append(
                f"collapse: positives ({align:.4f}) and negatives "
                f"({neg:.4f}) both ~1 — all embeddings identical"
            )
        gnorm = means.get("health_grad_norm")
        if gnorm is not None and t.grad_norm_max and gnorm > t.grad_norm_max:
            findings.append(
                f"divergence: gradient norm {gnorm:.3g} > {t.grad_norm_max:g}"
            )
        return findings

    def ingest(self, rows, gauges=None) -> list:
        """One flush window's ``(step, metrics)`` rows. Returns the
        findings (empty = healthy); raises under ``policy='abort'``."""
        fresh = 0
        for step, metrics in rows:
            fresh += self.observe(metrics, step)
        if not fresh:
            return []
        means = self.window_means()
        self.last_means = means
        if gauges is not None:
            gauges.set(**{k: v for k, v in means.items() if k != "step"})
        tracing.event(
            "health_window", track="health",
            **{k: round(v, 6) if isinstance(v, float) else v for k, v in means.items()},
        )
        findings = []
        nonfinite_total = sum(self.nonfinite_keys.values())
        if nonfinite_total > self._nonfinite_surfaced:
            self._nonfinite_surfaced = nonfinite_total
            findings.append(
                f"divergence: non-finite health metrics {sorted(self.nonfinite_keys)}"
            )
        if len(self._window) >= self.thresholds.min_samples:
            findings = self.verdicts(means) + findings
        if findings:
            self.alarms += 1
            tracing.event(
                "health_alarm", track="health", step=means["step"],
                policy=self.policy, findings=findings,
            )
            logging.warning(
                "representation health alarm at step %d (policy=%s): %s",
                means["step"], self.policy, "; ".join(findings),
            )
            if self.policy == "abort":
                raise RepresentationHealthError(findings, means["step"])
        return findings
