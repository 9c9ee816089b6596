"""CPU threads for the port's tests.

torch's intra-op pool defaults to one thread per core in every process, so
the workers of a ``pytest -n N`` run (pytest-xdist) ask for N times the
host's cores and spend their time switching. Each ``test_torch_port_*.py``
module calls :func:`limit_threads` when it is imported, which gives each
worker its share of the cores.
"""

import os

import torch


def limit_threads() -> int:
    """Set torch's intra-op threads to the cores over the xdist workers
    (``PYTEST_XDIST_WORKER_COUNT``, 1 outside xdist), at least one; returns
    the count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(threads)
    return threads
