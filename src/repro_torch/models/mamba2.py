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

Under a sharding context the layer runs on this rank's heads where its
weights hold them (``models/transformer.py``'s ``_split_dim``: ``w_z`` /
``w_x`` / ``w_dt`` / ``conv_x`` / ``A_log`` / ``D`` / ``dt_bias`` /
``norm`` their heads' share of ``d_in`` or ``H``, ``w_out`` its rows;
``w_B`` / ``w_C`` / ``conv_B`` / ``conv_C`` whole): the SSD scan sees only
them, the gated norm over all of ``d_in`` sums the group's squares, and
the model group sums the output projection.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.sharding import comm


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
    # the tail is a copy: a view would keep all of xp alive in a cache
    return F.silu(y), xp[:, -(cw - 1):].clone()


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


def _split(w: dict, cfg: ModelConfig) -> bool:
    """Whether ``w`` holds this rank's share of the heads."""
    return w["A_log"].shape[-1] < dims(cfg)[1]


def _gated_norm(y, z, w_norm, cfg: ModelConfig, ctx):
    """``rms_norm(y * silu(z))`` over all of ``d_in``.  With ``ctx`` (y, z
    and ``w_norm`` this rank's share of ``d_in``) the mean of squares
    takes the model group's sum of the local sums of squares; that sum's
    backward sums too (``comm.reduce_model``), since each rank uses it
    only for its own share."""
    g = y * F.silu(z)
    if ctx is None:
        return layers.rms_norm(g, w_norm, cfg.norm_eps)
    gf = g.float()
    ss = comm.reduce_model((gf * gf).sum(dim=-1, keepdim=True), ctx)
    var = ss / (gf.shape[-1] * ctx.msize)
    return (gf * torch.rsqrt(var + cfg.norm_eps) * w_norm.float()).to(g.dtype)


def _project(w: dict, x: torch.Tensor, ctx):
    """(z, xs, B_, C_, dt before its softplus) of x.  With ``ctx`` z / xs /
    dt are this rank's columns, and their input enters through
    ``comm.to_model_region`` (its gradient the group's sum); B_ / C_,
    read by every head, take x as it is."""
    xh = comm.to_model_region(x, ctx) if ctx is not None else x
    return (xh @ w["w_z"], xh @ w["w_x"], x @ w["w_B"], x @ w["w_C"],
            xh @ w["w_dt"])


def _out(w: dict, y, ctx):
    y = y @ w["w_out"]
    return comm.from_model_region(y, ctx) if ctx is not None else y


def mamba2_forward(w: dict, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """x (B,L,d) from a zero state and empty conv tails -> (y (B,L,d),
    (final_state, conv_tails)).  L % chunk == 0.  The reference's
    ``state`` / ``conv_tails`` arguments, which no caller of either package
    passes, are not taken.  Where ``w`` holds this rank's heads (under
    ``ctx``) the state and the ``conv_x`` tail are of those heads."""
    B, L, d = x.shape
    s = cfg.ssm
    ctx = ctx if _split(w, cfg) else None
    H, P = w["A_log"].shape[-1], s.head_dim
    d_in = H * P
    z, xs, B_, C_, dt = _project(w, x, ctx)
    dt = F.softplus(dt.float() + w["dt_bias"].float())
    xs, t_x = _causal_conv(xs, w["conv_x"])
    B_, t_B = _causal_conv(B_, w["conv_B"])
    C_, t_C = _causal_conv(C_, w["conv_C"])
    if ctx is not None:
        # every head reads B_ / C_: each rank's scan gives its heads'
        # share of their gradient, and the group sums the shares
        B_ = comm.to_model_region(B_, ctx)
        C_ = comm.to_model_region(C_, ctx)
    A = -torch.exp(w["A_log"]).float()

    cl = min(s.chunk, L)
    assert L % cl == 0, (L, cl)
    y, state = ssd_ops.ssd_scan(xs.reshape(B, L, H, P), dt, B_, C_, A,
                                w["D"].float(), chunk=cl)
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = _gated_norm(y, z, w["norm"], cfg, ctx)
    return _out(w, y, ctx), (state, (t_x, t_B, t_C))


def mamba2_decode(w: dict, x: torch.Tensor, cfg: ModelConfig, state,
                  conv_tails, ctx=None):
    """x (B,1,d) single-token step. state (B,H,P,N) f32;
    conv_tails: 3 tensors (B,cw-1,C).  Where ``w`` holds this rank's heads
    (under ``ctx``) so do ``state`` and the ``conv_x`` tail; the
    ``conv_B`` / ``conv_C`` tails are whole."""
    B = x.shape[0]
    ctx = ctx if _split(w, cfg) else None
    H, P = w["A_log"].shape[-1], cfg.ssm.head_dim
    d_in = H * P
    z, xs, B_, C_, dt = _project(w, x, ctx)
    dt = F.softplus(dt.float() + w["dt_bias"].float())[:, 0]
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
    y = _gated_norm(y, z, w["norm"], cfg, ctx)
    return _out(w, y, ctx), (state, (t_x, t_B, t_C))
