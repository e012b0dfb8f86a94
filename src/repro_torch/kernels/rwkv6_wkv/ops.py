"""Public wrapper for the WKV-6 kernel, plus the static per-tile DMA burst
list implied by its modeled tile grid (the §IV "schedule is the burst list"
contract; consumed by the FireBridge memory bridge and the online
congestion link, Fig. 8)."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.kernels.rwkv6_wkv import kernel as K


def wkv_scan(r, k, v, w, u, *, chunk=16, hb=8):
    """r/k/v/w (B,L,H,K); u (H,K) -> (y, final state); the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    return K.wkv_scan(r, k, v, w, u, chunk=chunk, hb=hb)


def transactions(B: int, L: int, H: int, K: int, V: int = 0, *,
                 chunk: int = 16, hb: int = 8,
                 dtype_bytes: int = 4) -> List[Tuple[str, str, int, int]]:
    """Per-tile DDR bursts of the modeled WKV grid (B, H/hb, L/chunk).

    Per grid cell: one r/k/v/w chunk fetch each and one y chunk write; per
    (batch, head-group) one u fetch and one final-state writeback.  The
    (hb, K, V) state stays on chip across the chunk sweep, so no
    dma_state traffic appears between chunks.
    """
    V = V or K
    chunk = min(chunk, L)
    groups = max(1, H // hb)
    r_base = 0
    span = B * L * H * K * dtype_bytes            # r/k/w each; v uses V
    k_base = r_base + span
    v_base = k_base + span
    w_base = v_base + B * L * H * V * dtype_bytes
    u_base = w_base + span
    y_base = u_base + H * K * dtype_bytes
    s_base = y_base + B * L * H * V * dtype_bytes
    rk_tile = chunk * hb * K * dtype_bytes
    v_tile = chunk * hb * V * dtype_bytes
    u_tile = hb * K * dtype_bytes
    state = hb * K * V * dtype_bytes
    txs: List[Tuple[str, str, int, int]] = []
    for b in range(B):
        for g in range(groups):
            txs.append(("dma_u", "read", u_base + g * u_tile, u_tile))
            for c in range(L // chunk):
                off = (b * groups + g) * (L // chunk) + c
                txs.append(("dma_r", "read",
                            r_base + off * rk_tile, rk_tile))
                txs.append(("dma_k", "read",
                            k_base + off * rk_tile, rk_tile))
                txs.append(("dma_v", "read", v_base + off * v_tile, v_tile))
                txs.append(("dma_w", "read",
                            w_base + off * rk_tile, rk_tile))
                txs.append(("dma_y", "write",
                            y_base + off * v_tile, v_tile))
            txs.append(("dma_state", "write",
                        s_base + (b * groups + g) * state, state))
    return txs
