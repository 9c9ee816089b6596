"""Logging: a stream handler everywhere and the reference's ``log-ing`` file
in the run folder (reference ``util.py:98-114``), written by rank 0 only;
the other processes of a data-parallel run log warnings and errors.
:class:`TBLogger` writes the reference's TensorBoard scalars (JAX
``utils/logging_utils.py:53-73``)."""

from __future__ import annotations

import logging
import os
import sys
import types
from typing import Optional

_FMT = "%(asctime)s %(filename)s [line:%(lineno)d] %(levelname)s %(message)s"


def setup_logging(work_dir: Optional[str] = None, main: bool = True) -> None:
    """Add a stream handler to the root logger (once) and a file handler
    writing ``<work_dir>/log-ing`` (once per target file). A process that is
    not ``main`` (not rank 0) logs warnings and errors only, and no file."""
    root = logging.getLogger()
    root.setLevel(logging.INFO if main else logging.WARNING)
    if not main:
        work_dir = None
    if not any(
        isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
        for h in root.handlers
    ):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FMT))
        root.addHandler(sh)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        target = os.path.abspath(os.path.join(work_dir, "log-ing"))
        if not any(
            isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == target
            for h in root.handlers
        ):
            fh = logging.FileHandler(target)
            fh.setFormatter(logging.Formatter(_FMT))
            root.addHandler(fh)


class TBLogger:
    """``tb_logger.Logger``-compatible facade over ``SummaryWriter``; a
    no-op off the main process. Without ``tensorboard`` installed it warns
    and stays disabled, as the JAX package's does. It writes scalars only,
    which tensorboard serves through its own TensorFlow stub: marking
    ``tensorboard.compat.notf`` keeps an installed TensorFlow (seconds to
    import, and nothing the port uses) out of the process."""

    def __init__(self, logdir: str, enabled: bool = True):
        self._writer = None
        if enabled:
            os.makedirs(logdir, exist_ok=True)
            try:
                sys.modules.setdefault("tensorboard.compat.notf",
                                       types.ModuleType("tensorboard.compat.notf"))
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=logdir, flush_secs=2)
            except Exception as e:  # noqa: BLE001 - an optional dependency
                logging.warning("TensorBoard writer unavailable (%s); disabled", e)

    def log_value(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
