"""The ``compiled`` backend of the co-verification tables
(``*/sweep.py``): the oracle's maths compiled once per table, the twin of
the reference's ``jax.jit`` of its reference function — the deployment
tier, never a kernel of the port.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch._device import true_fp32


def compiled_tier(oracle_fn: Callable, on_dev: Callable, **kw) -> Callable:
    """A backend callable (host numpy in and out) running
    ``torch.compile`` of ``oracle_fn``'s body (its ``true_fp32`` decorator
    unwrapped, and applied around the call instead, so that the compiled
    products stay fp32).  The compile happens at the first call, for that
    call's shapes: a caller that times iterations makes that call first."""
    body = getattr(oracle_fn, "__wrapped__", oracle_fn)
    fn = torch.compile(lambda *xs: body(*xs, **kw), dynamic=False)

    def compiled(*arrays):
        with true_fp32():
            return fn(*(on_dev(a) for a in arrays)).cpu().numpy()
    return compiled
