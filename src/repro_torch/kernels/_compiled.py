"""The ``compiled`` backend of the co-verification tables
(``*/sweep.py``): the oracle's maths compiled once per table, the twin of
the reference's ``jax.jit`` of its reference function — the deployment
tier, never a kernel of the port.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch._device import true_fp32

# dynamo's compilation is not safe from two threads at once, and the cells
# of a sweep call the tables from a thread pool: a call whose shapes have
# not compiled yet holds this lock (calls of compiled shapes do not)
_compile_lock = threading.Lock()


def compiled_tier(oracle_fn: Callable, on_dev: Callable, **kw) -> Callable:
    """A backend callable (host numpy in and out) running
    ``torch.compile`` of ``oracle_fn``'s body (its ``true_fp32`` decorator
    unwrapped, and applied around the call instead, so that the compiled
    products stay fp32).  The compile happens at the first call, for that
    call's shapes: a caller that times iterations makes that call first.
    A first call for some shapes runs alone, whichever thread makes it."""
    body = getattr(oracle_fn, "__wrapped__", oracle_fn)
    fn = torch.compile(lambda *xs: body(*xs, **kw), dynamic=False)
    compiled_for = set()

    def compiled(*arrays):
        xs = [on_dev(a) for a in arrays]
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in xs)
        with true_fp32():
            if key in compiled_for:
                out = fn(*xs)
            else:
                with _compile_lock:
                    out = fn(*xs)
                    compiled_for.add(key)
        return out.cpu().numpy()
    return compiled
