#!/usr/bin/env python
"""CLI of the port's flight-recorder report (``utils/trace_report.py``).

    python scripts/port_trace_report.py --events <run_dir>/events.jsonl [--json out.json]
    python scripts/port_trace_report.py --fleet <run_dir> [--json out.json] [--trace merged.json]

Exits 0 when the attribution (or every fleet session's merge) is
consistent, else 1.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simclr_pytorch_distributed_tpu_torch.utils.trace_report import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
