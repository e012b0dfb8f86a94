"""Mamba-2 (SSD) layer: chunked state-space dual form + O(1) decode step —
the port of ``repro.models.mamba2``.

Chunked SSD is numerically safe everywhere: every exponent is a difference
cum_i - cum_j with i >= j of a cumulative sum of dA = dt * A <= 0, so all
exp() arguments are <= 0.  ``mamba2_forward`` — the whole-sequence forward (training) and prefill,
from a zero state — runs the SSD scan kernel over the sequence
(``kernels/mamba2_scan``: the hand-written CUDA kernel for CUDA tensors,
its plain version for CPU tensors), which adds the ``D`` skip itself.
``_ssd_chunk`` is the twin of the reference's lax scan body: under autograd
the kernel wrapper's backward runs the forward again through it (and the
``D`` skip) and differentiates that, the reference's training arithmetic,
since its forward never calls its Pallas kernel.  Decode stays
``mamba2_decode``.

Projections use separate matrices per component (z, x, B, C, dt) as in
the reference.  Where the reference mixes a bf16 operand into a float32
operation, JAX promotes it; the port casts it up explicitly (exact).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.models import layers


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.d_state


def mamba2_init(gen: Optional[torch.Generator], cfg: ModelConfig, dtype,
                shape_prefix=()) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in, H, P, N = dims(cfg)
    pre = tuple(shape_prefix)
    dev = gen.device if gen is not None else None
    full = lambda n, v: torch.full(pre + (n,), v, dtype=torch.float32,
                                   device=dev)
    return {
        "w_z": layers.dense_init(gen, d, d_in, dtype, shape_prefix=pre),
        "w_x": layers.dense_init(gen, d, d_in, dtype, shape_prefix=pre),
        "w_B": layers.dense_init(gen, d, N, dtype, shape_prefix=pre),
        "w_C": layers.dense_init(gen, d, N, dtype, shape_prefix=pre),
        "w_dt": layers.dense_init(gen, d, H, dtype, shape_prefix=pre),
        "conv_x": layers.normal(gen, pre + (s.conv_width, d_in), 0.1, dtype),
        "conv_B": layers.normal(gen, pre + (s.conv_width, N), 0.1, dtype),
        "conv_C": layers.normal(gen, pre + (s.conv_width, N), 0.1, dtype),
        "A_log": full(H, 0.0),
        "D": full(H, 1.0),
        "dt_bias": full(H, -1.0),
        "norm": full(d_in, 1.0),
        "w_out": layers.dense_init(gen, d_in, d, dtype, shape_prefix=pre),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x (B,L,C), w (cw,C).
    tail (B,cw-1,C) continues a previous segment.  Returns (y, new_tail);
    the sum runs over the taps in the reference's order."""
    cw = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    dt = torch.promote_types(x.dtype, tail.dtype)
    xp = torch.cat([tail.to(dt), x.to(dt)], dim=1)
    L = x.shape[1]
    y = xp[:, 0:L] * w[0][None, None, :]
    for i in range(1, cw):
        y = y + xp[:, i:i + L] * w[i][None, None, :]
    return F.silu(y), xp[:, -(cw - 1):]


def _ssd_chunk(state, xs, dt, A, B_, C_):
    """One SSD chunk.  state (B,H,P,N); xs (B,c,H,P); dt (B,c,H) f32;
    A (H,) f32 (negative); B_/C_ (B,c,N).  Returns (state', y (B,c,H,P))."""
    dA = dt * A                                            # (B,c,H) <= 0
    cum = torch.cumsum(dA, dim=1)                          # (B,c,H)
    CB = torch.einsum("bin,bjn->bij", C_.float(), B_.float())   # (B,c,c)
    seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,c,c,H) i,j
    c = xs.shape[1]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=xs.device))[None, :, :, None]
    M = CB[..., None] * torch.exp(torch.where(
        causal, seg, torch.full_like(seg, float("-inf"))))
    M = M * dt[:, None, :, :]                              # weight by dt_j
    y = torch.einsum("bijh,bjhp->bihp", M, xs.float())
    # inter-chunk (contribution of incoming state)
    y = y + torch.einsum("bin,bhpn->bihp", C_.float(),
                         state) * torch.exp(cum)[..., None]
    # state update
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)         # (B,c,H) <= 1
    wx = xs.float() * (dt * decay_to_end)[..., None]
    state = state * torch.exp(cum[:, -1])[..., None, None] + \
        torch.einsum("bjn,bjhp->bhpn", B_.float(), wx)
    return state, y


def mamba2_forward(w: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B,L,d) from a zero state and empty conv tails -> (y (B,L,d),
    (final_state, conv_tails)).  L % chunk == 0.  The reference's
    ``state`` / ``conv_tails`` arguments, which no caller of either package
    passes, are not taken."""
    B, L, d = x.shape
    s = cfg.ssm
    d_in, H, P, N = dims(cfg)
    z = x @ w["w_z"]
    xs = x @ w["w_x"]
    B_ = x @ w["w_B"]
    C_ = x @ w["w_C"]
    dt = F.softplus((x @ w["w_dt"]).float() + w["dt_bias"].float())
    xs, t_x = _causal_conv(xs, w["conv_x"])
    B_, t_B = _causal_conv(B_, w["conv_B"])
    C_, t_C = _causal_conv(C_, w["conv_C"])
    A = -torch.exp(w["A_log"]).float()

    cl = min(s.chunk, L)
    assert L % cl == 0, (L, cl)
    y, state = ssd_ops.ssd_scan(xs.reshape(B, L, H, P), dt, B_, C_, A,
                                w["D"].float(), chunk=cl)
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), w["norm"], cfg.norm_eps)
    return y @ w["w_out"], (state, (t_x, t_B, t_C))


def mamba2_decode(w: dict, x: torch.Tensor, cfg: ModelConfig, state,
                  conv_tails):
    """x (B,1,d) single-token step. state (B,H,P,N) f32;
    conv_tails: 3 tensors (B,cw-1,C)."""
    B = x.shape[0]
    d_in, H, P, N = dims(cfg)
    z = x @ w["w_z"]
    xs = x @ w["w_x"]
    B_ = x @ w["w_B"]
    C_ = x @ w["w_C"]
    dt = F.softplus((x @ w["w_dt"]).float() + w["dt_bias"].float())[:, 0]
    t_x, t_B, t_C = conv_tails
    xs, t_x = _causal_conv(xs, w["conv_x"], t_x)
    B_, t_B = _causal_conv(B_, w["conv_B"], t_B)
    C_, t_C = _causal_conv(C_, w["conv_C"], t_C)
    A = -torch.exp(w["A_log"]).float()

    xs1 = xs[:, 0].reshape(B, H, P).float()
    B1 = B_[:, 0].float()                                   # (B,N)
    C1 = C_[:, 0].float()
    dA = torch.exp(dt * A)                                  # (B,H)
    state = state * dA[..., None, None] + \
        torch.einsum("bn,bhp->bhpn", B1, xs1 * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", C1, state)
    y = y + w["D"].float()[None, :, None] * xs1
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), w["norm"], cfg.norm_eps)
    return y @ w["w_out"], (state, (t_x, t_B, t_C))
