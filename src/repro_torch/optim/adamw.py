"""AdamW with warmup+cosine schedule and global-norm clipping — the port of
``repro.optim.adamw``.

Not ``torch.optim.AdamW``: the reference clips by the global norm first,
decays every leaf (norm weights included) and bias-corrects with
``t = step`` after incrementing ``step``.  Updates are made in place under
``torch.no_grad()`` (the reference builds new arrays; in place saves a copy
of parameters and moments, 15 GB at llama3.2-1b).  Moments are fp32.
Scalars (step, lr, bias corrections) are fp32 tensors on the parameters'
device, as the reference computes them in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch._tree import leaves as _leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales ``grads`` in place; returns (grads, norm before clipping)."""
    leaves = _leaves(grads)
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 opt: dict) -> Tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params``, ``opt["m"]``, ``opt["v"]``
    and ``grads`` (clipped).  Returns (params, opt, {"lr", "grad_norm"})."""
    step = opt["step"] + 1
    lr = lr_schedule(cfg, step)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(opt["m"]),
                          _leaves(opt["v"])):
        g = g.float()
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        # delta = m/bc1 / (sqrt(v/bc2) + eps) + wd * p;  p -= lr * delta
        delta = torch.sqrt(v / bc2).add_(cfg.eps)
        delta = torch.div(m / bc1, delta).add_(p.float(), alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr).to(p.dtype))
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


def same_layout(mesh, a, b) -> bool:
    """Whether two placement tuples put the same elements on every rank
    (along a mesh dim of one rank every placement does)."""
    return all(x == y or mesh.size(i) == 1
               for i, (x, y) in enumerate(zip(a, b)))


def to_layout(t, placements):
    """The DTensor ``t`` in ``placements`` (no move where the layouts
    already hold the same elements)."""
    if same_layout(t.device_mesh, t.placements, placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _replicas(t) -> int:
    """How many ranks hold each element of the DTensor ``t``."""
    from torch.distributed.tensor import Replicate
    return math.prod(t.device_mesh.size(i) for i, pl in
                     enumerate(t.placements) if isinstance(pl, Replicate))


@torch.no_grad()
def adamw_update_sharded(cfg: AdamWConfig, params: Any, grads: Any,
                         opt: dict) -> Tuple[Any, dict, dict]:
    """``adamw_update`` on DTensor leaves, each rank on its shards: the
    same elementwise steps in the same order, the moments' layout for the
    update (ZeRO), and the parameters brought back to their own layout
    (an all-gather over the data axes where the two differ).  The global
    norm sums each element once over the whole job."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    step = opt["step"]
    if isinstance(step, DTensor):                   # replicated: in place
        step.to_local().add_(1)
        t_step = step.to_local()
    else:
        step = t_step = step + 1
    lr = lr_schedule(cfg, t_step)
    t = t_step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    ms, vs = _leaves(opt["m"]), _leaves(opt["v"])
    gs = [to_layout(g, m.placements).to_local()
          for g, m in zip(_leaves(grads), ms)]
    sq = sum(g.float().square().sum() / _replicas(m)
             for g, m in zip(gs, ms))
    if dist.is_initialized() and dist.get_world_size() > 1:
        sq = sq.detach().clone()
        dist.all_reduce(sq)
    gn = torch.sqrt(sq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for p, g, m, v in zip(_leaves(params), gs, ms, vs):
        g.mul_(scale)
        g = g.float()
        ml, vl = m.to_local(), v.to_local()
        ml.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        vl.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        pm = to_layout(p, m.placements).to_local()
        delta = torch.sqrt(vl / bc2).add_(cfg.eps)
        delta = torch.div(ml / bc1, delta).add_(pm.float(),
                                                alpha=cfg.weight_decay)
        delta = delta.mul_(lr).to(p.dtype)
        if not same_layout(p.device_mesh, p.placements, m.placements):
            delta = DTensor.from_local(
                delta, m.device_mesh, m.placements, run_check=False,
                shape=m.shape, stride=m.stride()).redistribute(
                    p.device_mesh, p.placements).to_local()
        p.to_local().sub_(delta)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}
