"""Public wrapper for the SSD scan kernel, differentiable by recompute,
plus the static per-tile DMA burst list implied by its modeled tile grid
(the §IV "schedule is the burst list" contract; consumed by the FireBridge
memory bridge and the online congestion link, Fig. 8)."""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels._recompute import recompute_grads
from repro_torch.kernels.mamba2_scan import kernel as K


def ssd_scan_twin(x, dt, B_, C_, A, D, *, chunk=128):
    """The reference's training arithmetic for the same function: its lax
    scan of ``models/mamba2.py::_ssd_chunk`` over chunks of ``chunk`` steps
    from a zero state, then the ``D x`` skip that its ``mamba2_forward``
    adds, in plain (differentiable) tensor ops.  Returns ``(y, final
    state)`` as ``ssd_scan`` does."""
    from repro_torch.models.mamba2 import _ssd_chunk    # models import ops
    Bsz, L, H, P = x.shape
    cl = min(chunk, L)
    state = torch.zeros((Bsz, H, P, B_.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(L // cl):
        rows = slice(c * cl, (c + 1) * cl)
        state, yc = _ssd_chunk(state, x[:, rows], dt[:, rows], A,
                               B_[:, rows], C_[:, rows])
        ys.append(yc)
    y = torch.cat(ys, dim=1) + D.float()[None, None, :, None] * x.float()
    return y, state


class _SSD(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or its plain version (CPU
    tensors).  Backward, on both devices: the forward again through
    ``ssd_scan_twin`` on detached inputs under autograd, then
    ``torch.autograd.grad`` with the incoming gradients
    (``kernels/_recompute.py``) — the reference differentiates exactly that
    scan."""

    @staticmethod
    def forward(ctx, x, dt, B_, C_, A, D, chunk, hb):
        ctx.save_for_backward(x, dt, B_, C_, A, D)
        ctx.twin_kw = dict(chunk=chunk)
        return K.ssd_scan(x, dt, B_, C_, A, D, chunk=chunk, hb=hb)

    @staticmethod
    def backward(ctx, gy, gstate):
        return (*recompute_grads(ctx, ssd_scan_twin, gy, gstate), None,
                None)


def ssd_scan(x, dt, B_, C_, A, D, *, chunk=128, hb=8):
    """x (B,L,H,P); dt (B,L,H); B_/C_ (B,L,N); A/D (H,) -> (y, final
    state); the kernel for CUDA tensors, its plain version for CPU
    tensors; differentiable (backward by recompute through
    ``ssd_scan_twin``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, B_, C_, A, D)):
        return _SSD.apply(x, dt, B_, C_, A, D, chunk, hb)
    return K.ssd_scan(x, dt, B_, C_, A, D, chunk=chunk, hb=hb)


def transactions(B: int, L: int, H: int, P: int, N: int, *,
                 chunk: int = 128, hb: int = 8,
                 dtype_bytes: int = 4) -> List[Tuple[str, str, int, int]]:
    """Per-tile DDR bursts of the modeled SSD scan grid (B, H/hb, L/chunk).

    Per grid cell: one x/dt/B/C chunk fetch each and one y chunk write;
    per (batch, head-group) one final-state writeback.  The state stays
    on chip and never round-trips — visible here as the absence of
    dma_state traffic inside the chunk sweep.
    """
    chunk = min(chunk, L)
    x_base = 0
    dt_base = x_base + B * L * H * P * dtype_bytes
    b_base = dt_base + B * L * H * dtype_bytes
    c_base = b_base + B * L * N * dtype_bytes
    y_base = c_base + B * L * N * dtype_bytes
    s_base = y_base + B * L * H * P * dtype_bytes
    x_tile = chunk * hb * P * dtype_bytes
    dt_tile = chunk * hb * dtype_bytes
    bc_tile = chunk * N * dtype_bytes
    state = hb * P * N * dtype_bytes
    txs: List[Tuple[str, str, int, int]] = []
    for b in range(B):
        for g in range(max(1, H // hb)):
            for c in range(L // chunk):
                off = ((b * max(1, H // hb) + g) * (L // chunk) + c)
                txs.append(("dma_x", "read", x_base + off * x_tile, x_tile))
                txs.append(("dma_dt", "read",
                            dt_base + off * dt_tile, dt_tile))
                bc_off = (b * (L // chunk) + c) * bc_tile
                txs.append(("dma_bc", "read", b_base + bc_off, bc_tile))
                txs.append(("dma_bc", "read", c_base + bc_off, bc_tile))
                txs.append(("dma_y", "write", y_base + off * x_tile, x_tile))
            txs.append(("dma_state", "write",
                        s_base + (b * max(1, H // hb) + g) * state, state))
    return txs
