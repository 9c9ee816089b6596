"""Non-finite-loss detection, the failure policy and the drivers' typed
exit codes.

The subset of the JAX package's ``utils/guard.py:47-162`` the port's
drivers use. A non-finite loss seen at a step's metrics readback raises
:class:`NonFiniteLossError`; the pretrain driver then saves
``crash_epoch_N.pth`` from the epoch-top state (``--nan_guard``) and asks
its :class:`FailurePolicy` (``--nan_policy``) what to do: ``abort`` exits
1; ``rollback`` restores the epoch-top state, skips the epoch and damps the
learning rate by :data:`ROLLBACK_LR_MULT`, at most :data:`MAX_ROLLBACKS`
times, after which it exits 1 too. ``main()`` runs through
:func:`exit_with_code`:

- 0: a clean run;
- 1 (:data:`EXIT_NONFINITE`): a non-finite loss;
- 75 (``utils/preempt.EXIT_PREEMPTED``): preempted, state saved;
- any other exception propagates (the interpreter's 1).

In a data-parallel run the loss is the global batch's, the same on every
process, so every process raises at the same step, and every process rolls
back or exits 1 there.

The JAX package's codes 2 (a telemetry flush failure) and 3 (a
representation-health abort) wait for the port of the telemetry flush and
``HealthMonitor``.
"""

from __future__ import annotations

import logging
import math

EXIT_NONFINITE = 1

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
    ``None`` -> 0, ``SystemExit`` its own code, :class:`NonFiniteLossError`
    -> 1, anything else 1 (a plain crash)."""
    if exc is None:
        return 0
    if isinstance(exc, SystemExit):
        code = exc.code
        if code is None:
            return 0
        return code if isinstance(code, int) else 1
    if isinstance(exc, NonFiniteLossError):
        return EXIT_NONFINITE
    return 1


def exit_with_code(run_fn):
    """The drivers' ``main()`` epilogue: return ``run_fn()``'s value, turn
    a typed failure into ``SystemExit`` with its code (traceback logged),
    and let everything else (``SystemExit(75)``, real bugs) propagate."""
    try:
        return run_fn()
    except NonFiniteLossError as e:
        logging.exception("typed failure abort (exit code %d)", exit_code_for(e))
        raise SystemExit(exit_code_for(e)) from e
