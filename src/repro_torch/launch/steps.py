"""Step factories — the port of ``repro.launch.steps``: the train step
(forward + backward + AdamW, microbatched) and the sharding wiring of the
train / prefill / decode steps.

The state is the reference's pytree: ``{"params", "m", "v", "step"}`` with
fp32 master parameters (leaf tensors that require a gradient), fp32
moments and an int32 step.  A step updates it in place and returns it.
Under a sharding context the state's leaves are DTensors placed by
``train_shardings`` (``sharding/specs.py``'s ``place``): the step computes
each rank's share of the loss on its data shard (``make_loss_fn``), the
gradients come back summed in the parameters' layouts and are kept in
``grad_shardings``' (ZeRO) layout, and AdamW runs on each rank's shards.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch._tree import leaves, paths, tree_map, unflatten
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import inputs as inputs_lib
from repro_torch.models.transformer import (RunFlags, ShardCtx, init_cache,
                                            init_params, make_loss_fn)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     adamw_update_sharded, to_layout)
from repro_torch.sharding import comm
from repro_torch.sharding.specs import (P, Sharding, batch_specs, cache_specs,
                                        is_sharded, param_specs, to_shardings,
                                        zero_specs)


def make_train_state(cfg: ModelConfig, gen: Optional[torch.Generator]) -> dict:
    """Fresh state drawn from ``gen`` on its device (``gen=None``: shapes
    only, on the default device, e.g. under ``torch.device("meta")``)."""
    params = init_params(cfg, gen, dtype=torch.float32)
    params = tree_map(lambda p: p.requires_grad_(), params)
    return {"params": params, **adamw_init(params)}


def train_state_shape(cfg: ModelConfig) -> dict:
    """The state's structure, shapes and dtypes, with no storage."""
    with torch.device("meta"):
        return make_train_state(cfg, None)


def make_train_step(cfg: ModelConfig, flags: RunFlags,
                    ctx: Optional[ShardCtx] = None,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    grad_shardings: Any = None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    ``metrics = {"loss", "lr", "grad_norm"}`` (0-d tensors on the device).
    ``batch`` holds tensors on the parameters' device: under ``ctx`` the
    global batch, the same on every rank, and a state of DTensors.
    ``grad_shardings``: optional tree of ``Sharding``s for the gradient
    accumulator (ZeRO: data-axis sharded); the moments' layout otherwise."""
    loss_fn = make_loss_fn(cfg, flags, ctx)
    nm = flags.microbatches
    gsh = None
    if grad_shardings is not None:
        gsh = [sh for _, sh in paths(grad_shardings)]

    def grads_of(params, b):
        l, _ = loss_fn(params, b)
        gs = torch.autograd.grad(l, leaves(params))
        if ctx is None:
            return l.detach(), [g.float() for g in gs]
        gs = [g.float() for g in gs]
        if gsh is not None:
            gs = [to_layout(g, sh.placements) for g, sh in zip(gs, gsh)]
        # the shares of the data group sum to the loss
        return comm.sum_data(l.detach(), ctx), gs

    def train_step(state, batch):
        params = state["params"]
        if ctx is not None and not is_sharded(params):
            raise TypeError("under a sharding context the state's leaves "
                            "are DTensors (place it by train_shardings)")
        if nm == 1:
            loss, grads = grads_of(params, batch)
        else:
            mb = {k: v.reshape((nm, v.shape[0] // nm) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            loss, grads = None, None
            for i in range(nm):
                l, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    for acc, x in zip(grads, g):
                        _local(acc).add_(_local(x))
            loss = loss / nm
            for g in grads:
                _local(g).div_(nm)
        opt = {"m": state["m"], "v": state["v"], "step": state["step"]}
        if ctx is None:
            new_params, opt, info = adamw_update(
                opt_cfg, params, unflatten(params, grads), opt)
        else:
            new_params, opt, info = adamw_update_sharded(
                opt_cfg, params, unflatten(params, grads), opt)
        return {"params": new_params, **opt}, {"loss": loss, **info}

    return train_step


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def train_state_bytes_per_device(cfg: ModelConfig, mesh,
                                 zero_level: int) -> float:
    """Rough fit estimate: masters f32 + m/v f32 (+ bf16 cast transient)."""
    st = train_state_shape(cfg)
    msize = _mesh_axis_sizes(mesh)["model"]
    world = mesh.devices.size
    pbytes = sum(l.numel() * 4 for l in leaves(st["params"]))
    mv = 2 * pbytes / world if zero_level >= 1 else 2 * pbytes / msize
    masters = pbytes / world if zero_level >= 3 else pbytes / msize
    grads = pbytes / world if zero_level >= 1 else pbytes / msize
    return masters + mv + grads


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    ctx: ShardCtx, zero_level: int = 1):
    """zero_level: 0 = params/opt sharded on model only; 1 = moments + grad
    accumulators additionally sharded over data (ZeRO-1); 3 = master
    params too.  Returns (state shape, state shardings, batch shape, batch
    shardings, grad shardings or None)."""
    st_shape = train_state_shape(cfg)
    pspec = param_specs(cfg, st_shape["params"], mesh)
    zspec = zero_specs(pspec, st_shape["params"], mesh, ctx.data_axes)
    st_spec = {"params": zspec if zero_level >= 3 else pspec,
               "m": zspec if zero_level >= 1 else pspec,
               "v": zspec if zero_level >= 1 else pspec,
               "step": P()}
    b_shape = inputs_lib.train_input_specs(cfg, shape)
    b_spec = batch_specs(cfg, b_shape, mesh, data_axes=ctx.data_axes)
    gshard = to_shardings(zspec, mesh) if zero_level >= 1 else None
    return (st_shape, to_shardings(st_spec, mesh), b_shape,
            to_shardings(b_spec, mesh), gshard)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def serve_params_shape(cfg: ModelConfig) -> Any:
    with torch.device("meta"):
        return init_params(cfg, None, dtype=torch.bfloat16)


def prefill_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      ctx: ShardCtx):
    p_shape = serve_params_shape(cfg)
    p_spec = param_specs(cfg, p_shape, mesh)
    b_shape = inputs_lib.prefill_input_specs(cfg, shape)
    b_spec = batch_specs(cfg, b_shape, mesh, data_axes=ctx.data_axes)
    return (p_shape, to_shardings(p_spec, mesh), b_shape,
            to_shardings(b_spec, mesh))


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     ctx: ShardCtx):
    p_shape = serve_params_shape(cfg)
    p_spec = param_specs(cfg, p_shape, mesh)
    c_shape = init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")
    c_spec = cache_specs(cfg, c_shape, mesh, data_axes=ctx.data_axes)
    t_shape = inputs_lib.decode_token_specs(cfg, shape)
    dsize = math.prod(_mesh_axis_sizes(mesh)[a] for a in ctx.data_axes)
    t_spec = P(ctx.data_spec) if shape.global_batch % dsize == 0 and \
        shape.global_batch >= dsize else P(None)
    return (p_shape, to_shardings(p_spec, mesh), c_shape,
            to_shardings(c_spec, mesh), t_shape, Sharding(mesh, t_spec))
