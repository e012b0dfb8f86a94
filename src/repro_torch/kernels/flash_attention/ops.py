"""Public wrapper: flash attention with model-layout (B, S, H, D) in/out,
forward only for now.

Also derives the kernel's static per-tile DMA burst list from its modeled
tile grid (``transactions``) — the FireBridge §IV data-movement contract:
the schedule IS the burst list, fed to core/transactions.py for Fig. 8/9
profiling and to the online congestion link (§IV-C).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.kernels.flash_attention import kernel as K


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal=True,
                    window=0, bq=512, bk=512):
    """Model-layout entry point: q (B,S,H,D), k/v (B,S,KH,D).

    Positions are assumed to be arange (self-attention); q_pos/kv_pos are
    accepted for interface parity with the models' attention and ignored.
    Forward only: the dk/dv and dq kernels are queued, so an input that
    requires a gradient is refused rather than silently detached.
    """
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward-only in this port: the backward "
            "kernels (flash_dkdv, flash_dq) are queued; pass tensors with "
            "requires_grad=False")
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out, _ = K.flash_fwd(qt, kt, vt, causal=causal, window=window, bq=bq,
                         bk=bk)
    return out.transpose(1, 2)


def transactions(B: int, H: int, Sq: int, Sk: int, D: int, *,
                 bq: int = 512, bk: int = 512, causal: bool = True,
                 dtype_bytes: int = 2) -> List[Tuple[str, str, int, int]]:
    """Static per-tile DDR<->on-chip burst list implied by the modeled
    forward tile grid.

    Returns [(engine, direction, address, nbytes)] in grid order — per q
    block one q-tile fetch, a k/v-tile fetch per live KV block (causally
    masked tiles are skipped, matching the kernel's dead-tile skip), and
    one output-tile write.  This is the §IV "schedule is the burst list"
    contract used by MemoryBridge.log_burst_list and the congestion link
    (Fig. 8).
    """
    bq, bk = min(bq, Sq), min(bk, Sk)
    q_base = 0
    k_base = q_base + B * H * Sq * D * dtype_bytes
    v_base = k_base + B * H * Sk * D * dtype_bytes
    o_base = v_base + B * H * Sk * D * dtype_bytes
    q_tile = bq * D * dtype_bytes
    kv_tile = bk * D * dtype_bytes
    txs: List[Tuple[str, str, int, int]] = []
    for b in range(B):
        for h in range(H):
            bh_q = (b * H + h) * Sq * D * dtype_bytes
            bh_k = (b * H + h) * Sk * D * dtype_bytes
            for i in range(Sq // bq):
                txs.append(("dma_q", "read",
                            q_base + bh_q + i * q_tile, q_tile))
                for j in range(Sk // bk):
                    if causal and j * bk > (i + 1) * bq - 1:
                        continue                   # fully-masked tile skipped
                    txs.append(("dma_k", "read",
                                k_base + bh_k + j * kv_tile, kv_tile))
                    txs.append(("dma_v", "read",
                                v_base + bh_k + j * kv_tile, kv_tile))
                txs.append(("dma_o", "write",
                            o_base + bh_q + i * q_tile, q_tile))
    return txs
