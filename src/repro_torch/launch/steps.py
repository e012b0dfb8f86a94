"""Train-step factory (forward + backward + AdamW, microbatched) on one
device — the port of ``repro.launch.steps``.

The state is the reference's pytree: ``{"params", "m", "v", "step"}`` with
fp32 master parameters (leaf tensors that require a gradient), fp32
moments and an int32 step.  A step updates it in place and returns it.
The reference's sharding helpers (``train_shardings`` and the prefill /
decode ones) wait for the multi-device item (ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import RunFlags, init_params, make_loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


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


def make_train_step(cfg: ModelConfig, flags: RunFlags, ctx: Any = None,
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    ``metrics = {"loss", "lr", "grad_norm"}`` (0-d tensors on the device).
    ``batch`` holds tensors on the parameters' device."""
    loss_fn = make_loss_fn(cfg, flags, ctx)
    nm = flags.microbatches

    def grads_of(params, b):
        l, _ = loss_fn(params, b)
        gs = torch.autograd.grad(l, leaves(params))
        return l.detach(), [g.float() for g in gs]

    def train_step(state, batch):
        params = state["params"]
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
                        acc.add_(x)
            loss = loss / nm
            for g in grads:
                g.div_(nm)
        new_params, opt, info = adamw_update(
            opt_cfg, params, unflatten(params, grads),
            {"m": state["m"], "v": state["v"], "step": state["step"]})
        return {"params": new_params, **opt}, {"loss": loss, **info}

    return train_step

