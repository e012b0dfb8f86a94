"""Explicit collectives of the port's sharded paths, as autograd functions.

The reference lets GSPMD partition its programs and writes two regions as
``shard_map`` (the vocab-parallel embedding and the expert-parallel MoE).
The port runs every sharded path as explicit SPMD on local tensors: each
rank holds its share of the batch (the data axes) and computes the rest of
the step the same way as every other rank of its model group, except in
the regions that split work over the model axis (attention heads, the MLP
hidden dim, the vocab, the experts).  The functions here move activations
in and out of those regions so that autograd gives every rank the full
gradient of what it holds:

  * ``to_model_region``: identity; backward sums the gradient over the
    model group (each rank of the region saw only part of the use).
  * ``from_model_region``: sums the partial results over the model group;
    backward is the identity (the consumers are replicated).
  * ``reduce_model``: sums over the model group, and so does its
    backward: for a sum that each rank then uses only in its own share of
    a split dim (the mean of squares of an RMS norm over a split dim).
  * ``gather_model`` / ``split_model``: all-gather along a dim / keep this
    rank's chunk (backward: the chunk / the all-gather).
  * ``gather_data``: all-gather along a dim over the data group; backward
    sums over the data group and keeps this rank's chunk (each data rank's
    loss is its share of the global one).
  * ``max_model`` / ``sum_model`` (outside autograd): the combine of
    context-parallel decode attention over the model group.

A group of one rank costs nothing.  Where a group's backend is gloo and the
tensor is on a CUDA device, the bytes go through host memory (gloo reduces
CUDA tensors only for a few ops and types): ``HOST_STAGED`` counts those
calls.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

HOST_STAGED = {"calls": 0, "bytes": 0}


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, size: int,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) of ``t`` over ``group`` (a new tensor; ``t`` is not
    written)."""
    if size == 1:
        return t
    if _staged(t, group):
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += t.numel() * t.element_size()
        h = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    if size == 1:
        return t
    t = t.detach().contiguous()
    if _staged(t, group):
        # all-gather as an all-reduce of zero-padded blocks (gloo reduces
        # CUDA tensors; it gathers none)
        rank = dist.get_rank(group)
        parts = [torch.zeros_like(t) for _ in range(size)]
        parts[rank] = t
        return all_reduce(torch.cat(parts, dim=dim), group, size)
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, group, size: int, src: int) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every rank of ``group``."""
    if size == 1:
        return t
    out = t.detach().clone().contiguous()
    if _staged(t, group):
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += out.numel() * out.element_size()
        h = out.cpu()
        dist.broadcast(h, src=src, group=group)
        return h.to(t.device)
    dist.broadcast(out, src=src, group=group)
    return out


def _chunk(t: torch.Tensor, size: int, rank: int, dim: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{size} ways")
    return t.narrow(dim, rank * (n // size), n // size)


class _ToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.size), None, None


class _FromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        return all_reduce(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return all_reduce(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.size), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim, reduce_grad):
        ctx.args = (group, size, rank, dim, reduce_grad)
        return all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, rank, dim, reduce_grad = ctx.args
        if reduce_grad:
            g = all_reduce(g, group, size)
        return _chunk(g, size, rank, dim).contiguous(), *([None] * 5)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.args = (group, size, dim)
        return _chunk(x, size, rank, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, size, dim = ctx.args
        return all_gather(g, group, size, dim), None, None, None, None


def to_model_region(x: torch.Tensor, sctx) -> torch.Tensor:
    if sctx.msize == 1:
        return x
    g, _ = sctx.model_group
    return _ToRegion.apply(x, g, sctx.msize)


def from_model_region(x: torch.Tensor, sctx) -> torch.Tensor:
    if sctx.msize == 1:
        return x
    g, _ = sctx.model_group
    return _FromRegion.apply(x, g, sctx.msize)


def reduce_model(x: torch.Tensor, sctx) -> torch.Tensor:
    if sctx.msize == 1:
        return x
    g, _ = sctx.model_group
    return _Reduce.apply(x, g, sctx.msize)


def gather_model(x: torch.Tensor, sctx, dim: int) -> torch.Tensor:
    if sctx.msize == 1:
        return x
    g, _ = sctx.model_group
    return _Gather.apply(x, g, sctx.msize, sctx.model_rank, dim % x.dim(),
                         False)


def split_model(x: torch.Tensor, sctx, dim: int) -> torch.Tensor:
    if sctx.msize == 1:
        return x
    g, _ = sctx.model_group
    return _Split.apply(x, g, sctx.msize, sctx.model_rank, dim % x.dim())


def gather_data(x: torch.Tensor, sctx, dim: int = 0) -> torch.Tensor:
    if sctx.dsize == 1:
        return x
    g, _ = sctx.data_group
    return _Gather.apply(x, g, sctx.dsize, sctx.data_rank, dim % x.dim(),
                         True)


def data_chunk(x: torch.Tensor, sctx, dim: int = 0) -> torch.Tensor:
    """This data rank's chunk of a tensor replicated over the data group
    (a view; no communication)."""
    return _chunk(x, sctx.dsize, sctx.data_rank, dim % x.dim())


def sum_data(x: torch.Tensor, sctx) -> torch.Tensor:
    """Sum over the data group, outside autograd (metrics, counts)."""
    g, _ = sctx.data_group if sctx.dsize > 1 else (None, None)
    return all_reduce(x.detach(), g, sctx.dsize)


def max_model(x: torch.Tensor, sctx) -> torch.Tensor:
    """Elementwise max over the model group, outside autograd."""
    g, _ = sctx.model_group if sctx.msize > 1 else (None, None)
    return all_reduce(x.detach(), g, sctx.msize, dist.ReduceOp.MAX)


def sum_model(*xs: torch.Tensor, sctx) -> tuple:
    """Sums of ``xs`` over the model group in one collective, outside
    autograd."""
    if sctx.msize == 1:
        return xs
    g, _ = sctx.model_group
    flat = all_reduce(torch.cat([x.detach().reshape(-1) for x in xs]), g,
                      sctx.msize)
    return tuple(p.view_as(x) for p, x in
                 zip(flat.split([x.numel() for x in xs]), xs))


def from_data_rank0(x: torch.Tensor, sctx) -> torch.Tensor:
    """Data rank 0's ``x`` on every rank of the data group, outside
    autograd."""
    if sctx.dsize == 1:
        return x.detach()
    g, ranks = sctx.data_group
    return broadcast(x.detach(), g, sctx.dsize, ranks[0])
