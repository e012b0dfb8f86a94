"""The backward of the SSD scan kernel's wrapper (``mamba2_scan/ops.py``;
the WKV-6 one walks its chunks, ``rwkv6_wkv/ops.py``): no backward
kernel, but the forward run again
through the reference's own training arithmetic — the lax scans that
``jax.value_and_grad`` differentiates there, here the port's twins of
them — on detached inputs under autograd, then ``torch.autograd.grad``
with the incoming gradients.  One function for both devices, so the CPU
tests exercise the backward the card runs.
"""
from __future__ import annotations

import torch


def recompute_grads(ctx, twin, gy: torch.Tensor, gstate: torch.Tensor):
    """Gradients of the tensors ``ctx`` saved, through ``twin(*saved,
    **ctx.twin_kw) -> (y, final state)``.  Autograd hands in zeros for an
    output that nothing used (a final state in training), so such a state
    counts as having a zero gradient."""
    need = ctx.needs_input_grad[:len(ctx.saved_tensors)]
    ins = [t.detach().requires_grad_(n)
           for t, n in zip(ctx.saved_tensors, need)]
    if not any(need):
        return [None] * len(ins)
    with torch.enable_grad():
        y, state = twin(*ins, **ctx.twin_kw)
        got = iter(torch.autograd.grad(
            (y, state), [t for t in ins if t.requires_grad], (gy, gstate),
            allow_unused=True))
    return [next(got) if n else None for n in need]
