"""Public wrapper + static transaction-stream derivation for the FireBridge
memory bridge (the kernel's tile schedule IS its DMA burst list)."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.kernels.systolic_matmul.kernel import matmul as _matmul


def matmul(a, b, *, bm=128, bn=128, bk=128, out_dtype=None):
    return _matmul(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)


def transactions(M: int, N: int, K: int, *, bm=128, bn=128, bk=128,
                 dtype_bytes: int = 2) -> List[Tuple[str, str, int, int]]:
    """Static DDR<->on-chip transaction stream implied by the modeled
    ``(M/bm, N/bn, K/bk)`` tile schedule, k minor-most.

    Returns [(engine, direction, address, nbytes)] in grid order — the
    analogue of the AXI burst list FireBridge logs from its DMA VIPs
    (§IV).  Fed to core/transactions.py for Fig. 8/9-style profiling and
    arbitrated online by the congestion LinkModel (§IV-C) when the bridge
    runs with a CongestionConfig.  The schedule belongs to the modeled SoC,
    not to the device the maths runs on.
    """
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    txs: List[Tuple[str, str, int, int]] = []
    a_base, b_base = 0, M * K * dtype_bytes
    c_base = b_base + K * N * dtype_bytes
    for m in range(M // bm):
        for n in range(N // bn):
            for k in range(K // bk):
                txs.append(("dma_a", "read",
                            a_base + (m * (K // bk) + k) * bm * bk * dtype_bytes,
                            bm * bk * dtype_bytes))
                txs.append(("dma_b", "read",
                            b_base + (k * (N // bn) + n) * bk * bn * dtype_bytes,
                            bk * bn * dtype_bytes))
            txs.append(("dma_c", "write",
                        c_base + (m * (N // bn) + n) * bm * bn * dtype_bytes,
                        bm * bn * dtype_bytes))
    return txs
