#!/usr/bin/env python
"""CLI of the port's training-health report (``utils/health_report.py``).

    python scripts/port_health_report.py --events <run_dir>/events.jsonl \
        [--json out.json] [--recipe NAME] [--device cuda|cpu]

Prints the health timeline's table and findings; exits 0 when the health
stream is consistent, else 1.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simclr_pytorch_distributed_tpu_torch.utils.health_report import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
