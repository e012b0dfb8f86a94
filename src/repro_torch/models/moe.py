"""Mixture-of-Experts layer with sort-based capacity dispatch — the port of
``repro.models.moe``.

Tokens are sorted by expert (a stable sort, as ``jnp.argsort``), each
expert takes at most ``capacity`` of them in that order, and the overflow
is dropped.  The expert products are plain batched products over an
``(E, C, d)`` buffer, outside any kernel, as in the reference.

Where PyTorch differs from JAX the port pins the reference's semantics:

  * ``jax.lax.top_k`` puts the lowest index first among equal values;
    ``torch.topk`` promises no order for ties, so the top k are taken from
    a stable descending sort.
  * The reference scatters dropped rows to index ``E * C`` with
    ``mode="drop"``; here the index of the token each slot holds has one
    spare entry that takes them and is cut off.
  * The combine ``out.at[st].add(yt)`` becomes a gather of each token's k
    contributions in the sorted (ascending-expert) order, added one after
    the other in ``y``'s type: no atomic scatter-add, so the result does
    not depend on the order a device happens to run the adds in.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def moe_init(gen, cfg: ModelConfig, n_layers: int, dtype) -> dict:
    m = cfg.moe
    pre = (n_layers, m.n_experts)
    if cfg.mlp_type == "swiglu":
        w = {
            "w_gate": layers.dense_init(gen, cfg.d_model, m.expert_d_ff, dtype,
                                        shape_prefix=pre),
            "w_up": layers.dense_init(gen, cfg.d_model, m.expert_d_ff, dtype,
                                      shape_prefix=pre),
            "w_down": layers.dense_init(gen, m.expert_d_ff, cfg.d_model, dtype,
                                        shape_prefix=pre),
        }
    else:
        w = {
            "w_in": layers.dense_init(gen, cfg.d_model, m.expert_d_ff, dtype,
                                      shape_prefix=pre),
            "w_out": layers.dense_init(gen, m.expert_d_ff, cfg.d_model, dtype,
                                       shape_prefix=pre),
        }
    w["router"] = layers.dense_init(gen, cfg.d_model, m.n_experts,
                                    torch.float32, scale=0.1,
                                    shape_prefix=(n_layers,))
    return w


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lowest index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w: torch.Tensor, x: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (top-k idx (T,k), combine weights (T,k) f32, aux loss)."""
    logits = x.float() @ router_w.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    E = logits.shape[-1]
    frac = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()
    return idx, w, aux


def moe_apply(w: dict, x: torch.Tensor, cfg: ModelConfig, e0: int = 0,
              region=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux loss).  Sort-based capacity dispatch
    over all T tokens with the whole router ``w["router"]``; the experts
    that run are ``e0 .. e0 + El``, ``El`` those of ``w``'s expert
    weights (all of them by default).  With a share of the experts, out
    is that share of the layer's output: the shares of all experts sum to
    it.  The dispatch fills the running experts' (El·C, d) rows from an
    index of the token each slot holds, and the combine adds, for each of
    a token's k slots in ascending expert order, its expert's row or zero:
    no (T·k, d) buffer.  ``region`` (identity by default) is applied to
    the tokens the experts read and to the combine weights, not to the
    routing's tokens: it lets a caller sum those two gradients over the
    ranks that run the other experts."""
    m = cfg.moe
    T, d = x.shape
    C = capacity(cfg, T)
    E, k = m.n_experts, m.top_k
    up = w["w_gate"] if cfg.mlp_type == "swiglu" else w["w_in"]
    El = up.shape[0]
    dev = x.device

    idx, cw, aux = route(w["router"], x, k)                      # (T,k)
    if region is not None:
        x, cw = region(x), region(cw)
    e_flat = idx.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = cw.reshape(-1)

    order = torch.argsort(e_flat, stable=True)
    se, st, sw = e_flat[order], t_flat[order], w_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[se]
    here = (pos_in_e < C) & (se >= e0) & (se < e0 + El)
    dest = torch.where(here, (se - e0) * C + pos_in_e,
                       torch.full_like(se, El * C))              # spare row

    # the token each local slot holds (T: a zero row)
    slot_tok = torch.full((El * C + 1,), T, dtype=torch.long, device=dev)
    slot_tok[dest] = torch.where(here, st, torch.full_like(st, T))
    xz = torch.cat([x, x.new_zeros((1, d))])
    buf = xz[slot_tok[:El * C]].reshape(El, C, d)

    if cfg.mlp_type == "swiglu":
        g = torch.bmm(buf, w["w_gate"])
        u = torch.bmm(buf, w["w_up"])
        y = torch.bmm(F.silu(g) * u, w["w_down"])
    else:
        h = F.gelu(torch.bmm(buf, w["w_in"]), approximate="tanh")
        y = torch.bmm(h, w["w_out"])
    yz = torch.cat([y.reshape(El * C, d), y.new_zeros((1, d))])

    scale = (sw * here).to(y.dtype)
    by_token = torch.argsort(st, stable=True).reshape(T, k)
    out = torch.zeros((T, d), dtype=y.dtype, device=dev)
    for j in range(k):
        s = by_token[:, j]
        out = out + yz[dest[s]] * scale[s][:, None]
    return out, aux
