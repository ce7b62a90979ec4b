"""One share of this machine's cores for each pytest worker.

PyTorch's intra-op pool takes every core by default; under pytest-xdist
(``-n 6``) each worker's pool would compete with the others', and a
CPU-bound test of the port slows down many times over.  Every
``test_torch_*.py`` module calls ``share_cores()`` once it has imported
its modules (a spawned rank that imports the module calls it too).
"""

import os

import torch


def share_cores() -> int:
    """Set PyTorch's intra-op threads to the cores over the xdist workers
    (at least 1); returns the count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
