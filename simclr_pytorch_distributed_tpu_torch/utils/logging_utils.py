"""Logging: a stream handler everywhere and the reference's ``log-ing`` file
in the run folder (reference ``util.py:98-114``)."""

from __future__ import annotations

import logging
import os
from typing import Optional

_FMT = "%(asctime)s %(filename)s [line:%(lineno)d] %(levelname)s %(message)s"


def setup_logging(work_dir: Optional[str] = None) -> None:
    """Add a stream handler to the root logger (once) and a file handler
    writing ``<work_dir>/log-ing`` (once per target file)."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
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
