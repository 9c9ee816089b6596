"""Logging: a stream handler everywhere and the reference's ``log-ing`` file
in the run folder (reference ``util.py:98-114``), written by rank 0 only;
the other processes of a data-parallel run log warnings and errors."""

from __future__ import annotations

import logging
import os
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
