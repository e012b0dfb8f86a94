"""Processes that the port's tests start, one test at a time.

A ``tests/test_torch_*.py`` test that starts processes of its own (gloo
ranks through ``spawn``, a run-farm campaign's pool of spawned workers,
or a subprocess through ``run``: the reference in a process of its own,
a production dry-run cell, a clean interpreter) starts and joins them
inside ``ranks_lock``: an ``fcntl`` lock
on a file under the repository's ``build/``, so that across the workers
of a parallel pytest run (xdist) at most one such test runs its processes
at a time, and they do not crowd the CPU cores under the tests that time
themselves.  The lock is the process's own: it is released when its
holder exits, however it exits.
"""
import contextlib
import fcntl
import subprocess
from pathlib import Path

import torch.multiprocessing as mp

LOCK = Path(__file__).resolve().parents[1] / "build" / "test_ranks.lock"


@contextlib.contextmanager
def ranks_lock():
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def spawn(fn, args, nprocs: int) -> None:
    """``torch.multiprocessing.spawn(fn, args, nprocs)`` inside
    ``ranks_lock``."""
    with ranks_lock():
        mp.spawn(fn, args=args, nprocs=nprocs)


def run(*args, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run(*args, **kwargs)`` inside ``ranks_lock``."""
    with ranks_lock():
        return subprocess.run(*args, **kwargs)
