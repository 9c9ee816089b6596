"""Non-finite-loss detection and the drivers' typed exit codes.

The subset of the JAX package's ``utils/guard.py:63-130`` the port's
drivers use. A non-finite loss seen at a step's metrics readback raises
:class:`NonFiniteLossError`; the pretrain driver has by then saved
``crash_epoch_N.pth`` from the epoch-top state (``--nan_guard``, policy
``abort``). ``main()`` runs through :func:`exit_with_code`:

- 0: a clean run;
- 1 (:data:`EXIT_NONFINITE`): a non-finite loss;
- 75 (``utils/preempt.EXIT_PREEMPTED``): preempted, state saved;
- any other exception propagates (the interpreter's 1).

In a data-parallel run the loss is the global batch's, the same on every
process, so every process raises at the same step and exits 1.

The JAX package's codes 2 (a telemetry flush failure) and 3 (a
representation-health abort) wait for the port of the telemetry flush and
``HealthMonitor``.
"""

from __future__ import annotations

import logging
import math

EXIT_NONFINITE = 1


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
