"""Per-timestep oracle for the WKV-6 recurrence — the port of
``repro.kernels.rwkv6_wkv.ref``."""
from __future__ import annotations

import torch

from repro_torch._device import true_fp32


@true_fp32()
def wkv_scan_ref(r, k, v, w, u):
    """r/k/v/w (B,L,H,K); u (H,K).
    out_t = r_t . (S + u * k_t v_t^T); S = diag(w_t) S + k_t v_t^T.
    Returns (y (B,L,H,K) fp32, final state (B,H,K,K) fp32)."""
    B, L, H, K = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    state = torch.zeros((B, H, K, vf.shape[-1]), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(L):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = kt[..., None] * vt[..., None, :]                  # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                               state + uf[None, :, :, None] * kv))
        state = wt[..., None] * state + kv
    return torch.stack(ys, dim=1), state
