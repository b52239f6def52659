"""One share of the cores per test worker for torch's intra-op threads.

When pytest-xdist runs the tests in N worker processes, each worker's torch would otherwise start one
intra-op thread per core, so N workers run N times as many threads as there are cores, and their
spinning threads slow every other worker's JAX compiles. Under xdist (``PYTEST_XDIST_WORKER_COUNT``) each
worker keeps ``cores // N`` threads (at least one); a run in one process keeps torch's default. Importing
this module applies it (the curve cases import it, and every worker imports every test module).
"""

from __future__ import annotations

import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


share_cores()
