"""torch's thread pools capped in a test process: every
``tests/test_torch_*.py`` imports this module first.

pytest-xdist runs ``PYTEST_XDIST_WORKER_COUNT`` workers at once; each
would start torch with a pool of ``os.cpu_count()`` intra-op threads, so
the workers' pools oversubscribe the cores many times over and a
torch-heavy file slows down by far more than the load would say.  Here each
worker takes ``max(1, os.cpu_count() // workers)`` intra-op threads and as
many inter-op threads (one worker without xdist: every core).  A process
the tests spawn takes its share through :func:`child_env` (one thread a
rank for the gloo worlds, whose ranks set it themselves).
"""
import contextlib
import os

import torch


def threads_per_worker() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


def cap_threads(n: int) -> int:
    """Cap this process's torch pools at ``n`` threads; returns ``n``."""
    torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError:
        # the inter-op pool is fixed once torch has used it (or set it)
        pass
    return n


@contextlib.contextmanager
def default_threads():
    """torch's intra-op pool at its own default (``os.cpu_count()``
    threads) for the length of a ``with``, then the cap again: for a check
    whose bar holds at one order of a reduction's sums only."""
    n = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def child_env(env=None, threads: int = 0) -> dict:
    """``env`` (this process's by default) for a spawned process, its
    OpenMP pool capped at ``threads`` (this worker's share by default)."""
    out = dict(os.environ if env is None else env)
    out["OMP_NUM_THREADS"] = str(threads or THREADS)
    return out


THREADS = cap_threads(threads_per_worker())
