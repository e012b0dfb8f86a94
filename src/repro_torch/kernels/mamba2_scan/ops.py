"""Public wrapper for the SSD scan kernel, plus the static per-tile DMA
burst list implied by its modeled tile grid (the §IV "schedule is the
burst list" contract; consumed by the FireBridge memory bridge and the
online congestion link, Fig. 8)."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.kernels.mamba2_scan import kernel as K


def ssd_scan(x, dt, B_, C_, A, D, *, chunk=128, hb=8):
    """x (B,L,H,P); dt (B,L,H); B_/C_ (B,L,N); A/D (H,) -> (y, final
    state); the kernel for CUDA tensors, its plain version for CPU
    tensors."""
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
