"""Per-timestep recurrence oracle for the SSD scan kernel (exact, slow) —
the port of ``repro.kernels.mamba2_scan.ref``."""
from __future__ import annotations

import torch

from repro_torch._device import true_fp32


@true_fp32()
def ssd_scan_ref(x, dt, B_, C_, A, D):
    """x (B,L,H,P); dt (B,L,H); B_/C_ (B,L,N); A/D (H,).
    state_t = state * exp(dt_t A) + dt_t * x_t outer B_t;
    y_t = C_t . state_t + D * x_t.
    Returns (y (B,L,H,P) fp32, final state (B,H,P,N) fp32)."""
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B_, C_))
    Af, Df = A.float(), D.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        decay = torch.exp(dtt * Af[None, :])                    # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bn,bhp->bhpn", bt, xt * dtt[..., None])
        ys.append(torch.einsum("bn,bhpn->bhp", ct, state)
                  + Df[None, :, None] * xt)
    return torch.stack(ys, dim=1), state
