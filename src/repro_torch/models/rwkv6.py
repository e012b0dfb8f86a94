"""RWKV-6 ("Finch") layer: data-dependent-decay time-mix + channel-mix —
the port of ``repro.models.rwkv6``.

Decays are per channel (the K axis), so the recurrence is kept in its exact
per-step form.  Where ``time_mix`` starts from no state — the whole-sequence
forward (training) and prefill — it runs the WKV-6 kernel over the sequence
(``kernels/rwkv6_wkv``: the hand-written CUDA kernel for CUDA tensors, its
plain version for CPU tensors), which starts from a zero state as the
reference's scan does from ``zeros``.  Under autograd the wrapper's
backward runs the forward again through ``_wkv_chunk``, the twin of the
reference's lax scan, and differentiates that: the reference's training
arithmetic, since its forward never calls its Pallas kernel.  With a
carried state (decode) ``time_mix`` runs ``_wkv_chunk`` chunk by chunk: no
kernel launches there, as in the reference.

Where the reference mixes a bf16 operand into a float32 product, JAX
promotes the bf16 operand; PyTorch does not, so the port casts it up
explicitly (exact).

Under a sharding context both mixes run on this rank's share of the
weights that the reference's rule splits (``models/transformer.py``'s
``_split_dim``): the time-mix on its heads, the channel-mix on its share
of the hidden dim, each with a row-parallel output summed over the model
group (``sharding/comm.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import layers
from repro_torch.sharding import comm

CHUNK = 16
LORA_MIX = 32
LORA_DECAY = 64


def rwkv6_init(gen: Optional[torch.Generator], cfg: ModelConfig, dtype,
               shape_prefix=()) -> dict:
    d = cfg.d_model
    H, K = cfg.n_heads, cfg.rwkv.head_size
    pre = tuple(shape_prefix)
    f32 = torch.float32
    dev = gen.device if gen is not None else None
    nrm = lambda sh, sc: layers.normal(gen, pre + sh, sc, f32)
    zeros = lambda *sh: torch.zeros(pre + sh, dtype=f32, device=dev)
    return {
        "tmix": {
            "maa_x": zeros(d),
            "maa": nrm((5, d), 0.1),
            "maa_A": nrm((d, 5 * LORA_MIX), 0.01),
            "maa_B": nrm((5, LORA_MIX, d), 0.01),
            "decay_w": nrm((H * K,), 0.5),
            "decay_A": nrm((d, LORA_DECAY), 0.01),
            "decay_B": nrm((LORA_DECAY, H * K), 0.01),
            "u": nrm((H, K), 0.5),
            "w_r": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
            "w_k": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
            "w_v": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
            "w_g": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
            "w_o": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
            "ln": torch.ones(pre + (H, K), dtype=f32, device=dev),
        },
        "cmix": {
            "maa_k": zeros(d),
            "maa_r": zeros(d),
            "w_k": layers.dense_init(gen, d, cfg.d_ff, dtype, shape_prefix=pre),
            "w_v": layers.dense_init(gen, cfg.d_ff, d, dtype, shape_prefix=pre),
            "w_r": layers.dense_init(gen, d, d, dtype, shape_prefix=pre),
        },
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; prev (B,1,d) seeds t=0 (the result
    takes the wider of the two types, as ``jnp.concatenate`` does)."""
    dt = torch.promote_types(x.dtype, prev.dtype)
    return torch.cat([prev.to(dt), x[:, :-1].to(dt)], dim=1)


def _ddlerp(x, xprev, maa_x, maa, maa_A, maa_B):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g),
    stacked on dim 2: (B,L,5,d)."""
    dx = xprev - x                                          # (B,L,d)
    xxx = x + dx * maa_x
    lo = torch.tanh(xxx @ maa_A)                            # (B,L,5*32)
    B, L, _ = x.shape
    lo = lo.reshape(B, L, 5, LORA_MIX)
    mix = torch.einsum("blfr,frd->blfd", lo, maa_B)         # (B,L,5,d)
    return x[:, :, None, :] + dx[:, :, None, :] * (maa[None, None] + mix)


def _wkv_chunk(state, r, k, v, decay, u):
    """Exact WKV-6 recurrence over one chunk.
    state (B,H,K,V) f32; r/k/decay (B,c,H,K) f32; v (B,c,H,V) f32; u (H,K).
    The bonus term is factored as (r.u.k) v, as in the reference."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], decay[:, t]
        out = torch.einsum("bhk,bhkv->bhv", rt, state) + \
            (rt * u[None] * kt).sum(dim=-1)[..., None] * vt
        state = wt[..., None] * state + kt[..., None] * vt[:, :, None, :]
        outs.append(out)
    return state, torch.stack(outs, dim=1)                  # (B,c,H,V)


def time_mix(w: dict, x: torch.Tensor, cfg: ModelConfig, shift_prev,
             state: Optional[torch.Tensor], chunk: int = CHUNK, ctx=None):
    """x (B,L,d); shift_prev (B,1,d); state (B,H,K,V) f32, or None for a
    zero state (the WKV-6 kernel route).  Returns (y, shift, state).

    Where ``w`` holds this rank's heads (under ``ctx``: ``u`` / ``ln``
    have fewer rows than ``cfg.n_heads``, ``w_r`` / ``w_k`` / ``w_v`` /
    ``w_g`` / ``decay_w`` / ``decay_B`` the heads' columns, ``w_o`` their
    rows) the layer runs on them: the state is of those heads, the WKV-6
    scan sees only them, the per-head norm is local, and the model group
    sums the output projection.  The mixed inputs k / v / r / g and the
    LoRA decay hidden enter through ``comm.to_model_region``, so that the
    gradients of ``maa_*``, ``decay_A`` and ``x`` are the group's sums."""
    B, L, d = x.shape
    H, K = w["u"].shape[-2], cfg.rwkv.head_size
    split = H < cfg.n_heads
    region = (lambda t: comm.to_model_region(t, ctx)) if split else \
        (lambda t: t)
    xprev = _shift(x, shift_prev)
    mixed = _ddlerp(x, xprev, w["maa_x"], w["maa"], w["maa_A"], w["maa_B"])
    xw = mixed[:, :, 0]
    xk, xv, xr, xg = region(mixed[:, :, 1:]).unbind(2)
    r = (xr @ w["w_r"]).reshape(B, L, H, K).float()
    k = (xk @ w["w_k"]).reshape(B, L, H, K).float()
    v = (xv @ w["w_v"]).reshape(B, L, H, K).float()
    g = F.silu(xg @ w["w_g"])
    hid = region(torch.tanh(xw.float() @ w["decay_A"].float()))
    w_raw = w["decay_w"].float() + hid @ w["decay_B"].float()
    decay = torch.exp(-torch.exp(w_raw.reshape(B, L, H, K)))  # in (0,1)
    u = w["u"].float()

    cl = min(chunk, L)
    while L % cl:
        cl -= 1
    if state is None:
        y, state = wkv_ops.wkv_scan(r, k, v, decay, u, chunk=cl)
    else:
        ys = []
        for c in range(L // cl):
            rows = slice(c * cl, (c + 1) * cl)
            state, yc = _wkv_chunk(state, r[:, rows], k[:, rows], v[:, rows],
                                   decay[:, rows], u)
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    y = layers.head_rms_norm(y, w["ln"], cfg.norm_eps)
    y = (y.reshape(B, L, H * K) * g).to(x.dtype)
    out = y @ w["w_o"]
    if split:
        out = comm.from_model_region(out, ctx)
    # the shift is a copy: a view would keep all of x alive in a cache
    return out, x[:, -1:].clone(), state


def channel_mix(w: dict, x: torch.Tensor, shift_prev, ctx=None):
    """-> (y, shift).  ``ctx``: given where ``w_k`` / ``w_v`` hold this
    rank's share of the hidden dim (None where they are whole): ``xk``
    enters through ``comm.to_model_region`` and the model group sums
    ``kk @ w_v`` before the receptance gate (``w_r`` is whole)."""
    xprev = _shift(x, shift_prev)
    dx = xprev - x
    xk = x + dx * w["maa_k"]
    xr = x + dx * w["maa_r"]
    if ctx is not None:
        xk = comm.to_model_region(xk, ctx)
    kk = torch.square(F.relu(xk @ w["w_k"]))
    kv = kk @ w["w_v"]
    if ctx is not None:
        kv = comm.from_model_region(kv, ctx)
    out = torch.sigmoid(xr @ w["w_r"]) * kv
    return out, x[:, -1:].clone()
