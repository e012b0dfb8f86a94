"""Public wrapper for the WKV-6 kernel, differentiable by recompute, plus
the static per-tile DMA burst list implied by its modeled tile grid (the
§IV "schedule is the burst list" contract; consumed by the FireBridge
memory bridge and the online congestion link, Fig. 8)."""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels.rwkv6_wkv import kernel as K


def wkv_scan_twin(r, k, v, w, u, *, chunk=16):
    """The reference's training arithmetic for the same function: its lax
    scan of ``models/rwkv6.py::_wkv_chunk`` over chunks of ``chunk`` steps
    from a zero state, in plain (differentiable) tensor ops.  Returns
    ``(y, final state)`` as ``wkv_scan`` does."""
    from repro_torch.models.rwkv6 import _wkv_chunk    # models import ops
    B, L, H, Kd = r.shape
    cl = min(chunk, L)
    state = torch.zeros((B, H, Kd, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    ys = []
    for c in range(L // cl):
        rows = slice(c * cl, (c + 1) * cl)
        state, yc = _wkv_chunk(state, r[:, rows], k[:, rows], v[:, rows],
                               w[:, rows], u)
        ys.append(yc)
    return torch.cat(ys, dim=1), state


def _boundary_states(k, v, w, cl: int):
    """The twin's state entering each chunk of ``cl`` steps (the first a
    zero state), by its own state update, without outputs or autograd."""
    B, L, H, Kd = k.shape
    state = torch.zeros((B, H, Kd, v.shape[-1]), dtype=torch.float32,
                        device=k.device)
    out = [state]
    for t in range(L - cl):
        kt, vt, wt = k[:, t], v[:, t], w[:, t]
        state = wt[..., None] * state + kt[..., None] * vt[:, :, None, :]
        if (t + 1) % cl == 0:
            out.append(state)
    return out


def chunked_recompute_grads(ctx, gy: torch.Tensor, gstate: torch.Tensor):
    """The gradients ``recompute_grads`` gives through ``wkv_scan_twin``,
    holding the twin's state at the chunk boundaries only: one pass
    without autograd for those states, then the chunks in reverse, each
    recomputed under autograd from its entering state (``_wkv_chunk``,
    the twin's arithmetic) and differentiated with its share of ``gy``
    and the gradient of the state it hands on.  The whole-sequence
    recompute keeps every step's (B, H, K, V) state until its backward
    ends; this keeps L / chunk of them and one chunk's graph."""
    from repro_torch.models.rwkv6 import _wkv_chunk    # models import ops
    need = list(ctx.needs_input_grad[:5])
    if not any(need):
        return [None] * 5
    r, k, v, w, u = (t.detach() for t in ctx.saved_tensors)
    L = r.shape[1]
    cl = min(ctx.twin_kw["chunk"], L)
    with torch.no_grad():
        states = _boundary_states(k, v, w, cl)
    grads = [torch.zeros_like(t) if n else None
             for t, n in zip((r, k, v, w), need)]
    gu = torch.zeros_like(u) if need[4] else None
    gs = gstate
    for c in reversed(range(L // cl)):
        rows = slice(c * cl, (c + 1) * cl)
        ins = [t[:, rows].requires_grad_(n)
               for t, n in zip((r, k, v, w), need)]
        uu = u.requires_grad_(need[4])
        s0 = states[c].requires_grad_(c > 0)
        wrt = [t for t in ins + [uu, s0] if t.requires_grad]
        with torch.enable_grad():
            state, yc = _wkv_chunk(s0, *ins, uu)
            got = iter(torch.autograd.grad(
                (yc, state), wrt, (gy[:, rows], gs), allow_unused=True))
        for i, n in enumerate(need[:4]):
            if n:
                g = next(got)
                if g is not None:
                    grads[i][:, rows] = g
        if need[4]:
            g = next(got)
            if g is not None:
                gu = gu + g
        if c > 0:
            gs = next(got)
        states[c] = None
    return grads + [gu]


class _WKV(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or its plain version (CPU
    tensors).  Backward, on both devices: the forward again through the
    twin's arithmetic on detached inputs under autograd, chunk by chunk
    from the chunk-boundary states (``chunked_recompute_grads``) — the
    reference differentiates exactly that scan."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, hb):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.twin_kw = dict(chunk=chunk)
        return K.wkv_scan(r, k, v, w, u, chunk=chunk, hb=hb)

    @staticmethod
    def backward(ctx, gy, gstate):
        return (*chunked_recompute_grads(ctx, gy, gstate), None, None)


def wkv_scan(r, k, v, w, u, *, chunk=16, hb=8):
    """r/k/v/w (B,L,H,K); u (H,K) -> (y, final state); the kernel for CUDA
    tensors, its plain version for CPU tensors; differentiable (backward by
    recompute through ``wkv_scan_twin``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return _WKV.apply(r, k, v, w, u, chunk, hb)
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
