"""Public wrapper: flash attention with model-layout (B, S, H, D) in/out,
differentiable through the hand-written backward kernels.

``_Flash`` mirrors the reference's ``custom_vjp`` (``_flash`` / ``_fwd`` /
``_bwd``): the forward saves ``(q, k, v, out, lse)``; the backward takes
``delta = sum(dout * out)`` in fp32 with plain tensor ops (the reference
computes it outside any kernel too), calls the dk/dv and dq kernels and
casts their fp32 results to the input types.

Also derives the kernel's static per-tile DMA burst list from its modeled
tile grid (``transactions``) — the FireBridge §IV data-movement contract:
the schedule IS the burst list, fed to core/transactions.py for Fig. 8/9
profiling and to the online congestion link (§IV-C).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels.flash_attention import kernel as K


class _Flash(torch.autograd.Function):
    """Kernel layout (B, H, S, D) in and out."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk):
        out, lse = K.flash_fwd(q, k, v, causal=causal, window=window, bq=bq,
                               bk=bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, window=window, bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1)            # (B,H,Sq)
        dk, dv = K.flash_dkdv(q, k, v, dout, lse, delta, **ctx.cfg)
        dq = K.flash_dq(q, k, v, dout, lse, delta, **ctx.cfg)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal=True,
                    window=0, bq=512, bk=512):
    """Model-layout entry point: q (B,S,H,D), k/v (B,S,KH,D).

    Positions are assumed to be arange (self-attention); q_pos/kv_pos are
    accepted for interface parity with the models' attention and ignored.
    """
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = _Flash.apply(qt, kt, vt, causal, window, bq, bk)
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
