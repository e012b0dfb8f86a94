"""Explicit expert-parallel MoE — the port of ``repro.sharding.ep``.

Activations are replicated across "model", experts are sharded across
"model".  Each (data, model) rank routes its data shard's tokens, keeps
only the top-k assignments that hit ITS local experts, computes them with
a local sort-based capacity dispatch, and the model group sums the
combined output: one all-reduce of (T_loc, d) in the compute type, the
shape of a tensor-parallel MLP's reduction.

The reference writes this as a ``shard_map``; here it is the same body on
this rank's tensors, with the collectives of ``sharding/comm.py``.  The
dispatch keeps the reference's order: a stable sort of the local expert
ids with foreign assignments parked in bucket ``n_local`` (last), the
capacity sized from the tokens the body sees (its data shard's), so the
same assignments drop.  The combine adds each token's contributions in
ascending expert order, as ``models/moe.py`` does.

The aux loss is the reference's, quirk included: its ``shard_map`` returns
the aux under ``out_specs=P()`` with ``check_vma=False``, so the value is
device 0's — the route aux of data shard 0's tokens alone (averaged over
its model group, where it is the same on every rank) — while its gradient
is the data group's mean.  Every rank returns that value, with that
gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_lib
from repro_torch.sharding import comm


def _local_moe(x, router_w, wg, wu, wd, *, cfg, ctx, n_local: int):
    """The body each (data, model) rank runs: x (T_loc, d) replicated
    across the model axis; wg/wu/wd hold the n_local experts this rank
    owns."""
    m = cfg.moe
    T, d = x.shape
    k = m.top_k
    dev = x.device
    e_lo = ctx.model_rank * n_local

    idx, cw, aux = moe_lib.route(router_w, x, k)             # global expert ids
    e_flat = idx.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = cw.reshape(-1)
    loc = e_flat - e_lo
    mine = (loc >= 0) & (loc < n_local)
    loc = torch.where(mine, loc, torch.full_like(loc, n_local))  # parked

    C = moe_lib.capacity(cfg, T)                              # per expert
    order = torch.argsort(loc, stable=True)                   # parked last
    sl, st, sw, sm = loc[order], t_flat[order], w_flat[order], mine[order]
    counts = torch.zeros(n_local + 1, dtype=torch.long,
                         device=dev).scatter_add_(0, loc, torch.ones_like(loc))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sl]
    keep = sm & (pos_in_e < C)
    dest = torch.where(keep, sl * C + pos_in_e,
                       torch.full_like(sl, n_local * C))      # spare row

    buf = torch.zeros((n_local * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x[st] * keep[:, None].to(x.dtype)
    buf = buf[:n_local * C].reshape(n_local, C, d)

    if cfg.mlp_type == "swiglu":
        y = torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)
    else:
        y = torch.bmm(F.gelu(torch.bmm(buf, wg), approximate="tanh"), wd)
    y = y.reshape(n_local * C, d)

    yt = y[torch.where(keep, dest, torch.zeros_like(dest))]
    yt = yt * (sw * keep).to(y.dtype)[:, None]
    by_token = torch.argsort(st, stable=True).reshape(T, k)
    contrib = yt[by_token]                                    # (T, k, d)
    out = torch.zeros((T, d), dtype=y.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out, aux


def _local_experts(t: torch.Tensor, ctx, n_local: int, dim: int):
    """This rank's experts of ``t``: a DTensor, a whole plain tensor, or
    one already holding ``n_local`` of them along ``dim``."""
    from repro_torch.models.transformer import _compute_leaf
    return _compute_leaf(t, ctx, dim, full=n_local * ctx.msize)


def moe_apply_ep(w: dict, x: torch.Tensor, cfg, ctx
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out, aux).  Requires n_experts % model_axis_size == 0.

    ``x`` holds every token (the same on every rank) unless
    ``ctx.rows_split``, where it holds this data rank's share of them.
    Where the data axes divide the tokens, each data rank takes its
    contiguous share (the reference's ``P(data)`` in-spec) and the data
    group gathers the output; otherwise every data rank runs all of them,
    as the reference does.  ``w``'s expert leaves may be whole (E, ...),
    DTensors, or this rank's (E / model, ...)."""
    msize = ctx.msize
    n_local = cfg.moe.n_experts // msize
    if n_local * msize != cfg.moe.n_experts:
        raise ValueError(f"ep_shardmap needs the model axis ({msize}) to "
                         f"divide the {cfg.moe.n_experts} experts")
    T = x.shape[0]
    split = not ctx.rows_split and T % ctx.dsize == 0 and T >= ctx.dsize \
        and ctx.dsize > 1
    x_l = comm.data_chunk(x, ctx) if split else x

    if cfg.mlp_type == "swiglu":
        names = ("w_gate", "w_up", "w_down")
    else:
        names = ("w_in", "w_in", "w_out")
    dim = w[names[0]].dim() - 3                               # (..., E, a, b)
    wg, wu, wd = (_local_experts(w[n], ctx, n_local, dim) for n in names)
    router = comm.to_model_region(
        _local_experts(w["router"], ctx, n_local, None), ctx)
    out, aux = _local_moe(comm.to_model_region(x_l, ctx), router, wg, wu, wd,
                          cfg=cfg, ctx=ctx, n_local=n_local)
    # each token's k experts live on (possibly) different model ranks:
    # sum the partial combines — the ONLY cross-rank traffic of the layer
    out = comm.from_model_region(out, ctx)
    if msize > 1:
        aux = comm.from_model_region(aux / msize, ctx)        # model mean
    if ctx.dsize > 1:
        aux = aux + (comm.from_data_rank0(aux, ctx) - aux).detach()
    if split:
        out = comm.gather_data(out, ctx)
    return out, aux
