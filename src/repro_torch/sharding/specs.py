"""Rule-based PartitionSpec assignment — the port of
``repro.sharding.specs``.

Specs are derived from parameter *paths* + shapes with divisibility checks,
so one rule set covers all 10 architectures.  Baseline layout (Megatron
style):

  * embeddings / lm_head: vocab on "model"
  * attn: q heads on "model"; k/v heads on "model" only when KH divides it
  * mlp / experts: hidden (or expert) dim on "model"
  * batch on ("pod","data"); decode caches: batch on "data", time on "model"
    (context-parallel decode); SSM states: heads on "model", state on "data"

The rules read only a mesh's axis names and shape, so the port's spec trees
equal the reference's at any mesh size without devices.  A spec is the
port's own small ``PartitionSpec`` (one entry per dim: an axis name, a
tuple of axis names, or None).  ``to_shardings`` turns specs into
``Sharding``s: per mesh dim a DTensor ``Shard`` / ``Replicate`` placement,
a tuple entry such as ``("pod", "data")`` sharding its tensor dim over
both mesh dims, major to minor, as the reference's ``NamedSharding`` does.
``place`` / ``whole`` move a tree between whole tensors (the same on every
rank) and DTensors in those layouts with no communication but the gather;
``local_tree`` / ``from_local_tree`` between DTensors and their local
shards, with none.

The fabric layouts (multi-device co-verification, ``core/fabric.py``) are
at the end.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A tuple of per-dim axis names (``None`` = replicated dim)."""

    def __new__(cls, *axes: Axis) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def map_specs(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the ``PartitionSpec`` leaves of ``trees[0]`` (and the
    matching leaves of the other trees, which have its structure)."""
    def walk(node, *others):
        if node is None:
            return None
        if _is_spec(node):
            return fn(node, *others)
        if isinstance(node, dict):
            return {k: walk(node[k], *(o[k] for o in others))
                    for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, *(o[i] for o in others))
                              for i, v in enumerate(node))
        return fn(node, *others)
    return walk(*trees)


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _mesh_sizes(mesh, data_axes, model_axis):
    ax = _axis_sizes(mesh)
    return math.prod(ax[a] for a in data_axes), ax[model_axis]


def _map_with_path(rule, tree):
    # core/fabric.py imports this module, and core/ is under _tree's
    # imports: _tree is imported where it is used
    from repro_torch._tree import paths, unflatten
    return unflatten(tree, [rule(p, leaf) for p, leaf in paths(tree)])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param_rule(cfg, path: str, shape: Tuple[int, ...], msize: int,
                model: str) -> PartitionSpec:
    nd = len(shape)
    none = (None,) * nd

    def shard(dim: int) -> PartitionSpec:
        dim = dim % nd
        if not _div(shape[dim], msize):
            return P(*none)
        spec = [None] * nd
        spec[dim] = model
        return P(*spec)

    leaf = path.rsplit("/", 1)[-1]
    if leaf == "embed":
        return shard(0)
    if leaf == "lm_head":
        return shard(-1)
    # attention
    if leaf == "wq":
        return shard(-1)
    if leaf in ("wk", "wv"):
        return shard(-1) if _div(cfg.n_kv_heads, msize) else P(*none)
    if leaf == "wo":
        return shard(-2)
    # dense mlp / experts
    if "moe" in path and leaf in ("w_gate", "w_up", "w_down", "w_in", "w_out"):
        # experts dim is axis 1 of (L, E, ...)
        if nd >= 2 and _div(shape[1], msize):
            spec = [None] * nd
            spec[1] = model
            return P(*spec)
        return P(*none)
    if leaf in ("w_gate", "w_up", "w_in"):
        return shard(-1)
    if leaf == "w_down":
        return shard(-2)
    if leaf == "w_out" and "mamba" not in path and "blocks" in path:
        return shard(-2)
    # mamba2
    if "mamba" in path:
        if leaf in ("w_z", "w_x", "w_dt"):
            return shard(-1)
        if leaf == "w_out":
            return shard(-2)
        if leaf in ("conv_x", "A_log", "D", "dt_bias", "norm"):
            return shard(-1)
    # rwkv6
    if "tmix" in path:
        if leaf in ("w_r", "w_k", "w_v", "w_g", "decay_w"):
            return shard(-1)
        if leaf == "w_o":
            return shard(-2)
        if leaf in ("u", "ln"):
            return shard(-2)          # (H, K) -> heads
    if "cmix" in path:
        if leaf == "w_k":
            return shard(-1)
        if leaf == "w_v":
            return shard(-2)
    return P(*none)


def param_specs(cfg, params_shape: Any, mesh, model_axis: str = "model"):
    msize = _axis_sizes(mesh)[model_axis]
    return _map_with_path(
        lambda p, leaf: _param_rule(cfg, p, tuple(leaf.shape), msize,
                                    model_axis), params_shape)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_specs(cfg, batch_shape: Any, mesh,
                data_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model"):
    dsize, _ = _mesh_sizes(mesh, data_axes, model_axis)
    dspec = data_axes if len(data_axes) > 1 else data_axes[0]

    def rule(path, leaf):
        nd = len(leaf.shape)
        if nd >= 1 and _div(leaf.shape[0], dsize) and leaf.shape[0] > 1:
            return P(*((dspec,) + (None,) * (nd - 1)))
        return P(*((None,) * nd))

    return _map_with_path(rule, batch_shape)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_specs(cfg, cache_shape: Any, mesh,
                data_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model"):
    dsize, msize = _mesh_sizes(mesh, data_axes, model_axis)
    dspec = data_axes if len(data_axes) > 1 else data_axes[0]

    def rule(p, leaf):
        leafname = p.rsplit("/", 1)[-1]
        sh = tuple(leaf.shape)
        spec = [None] * len(sh)

        def put(dim, axis, size):
            if _div(sh[dim], size) and sh[dim] >= size:
                spec[dim] = axis
                return True
            return False

        if leafname in ("k", "v", "cross_k", "cross_v", "win_k", "win_v",
                        "win_pos"):
            put(1, dspec, dsize)     # (L,B,S,KH,hd) (nc,B,M,..) (ns,B,W,..)
            put(2, model_axis, msize)
        elif leafname == "kv_pos":                 # (B,S)
            put(0, dspec, dsize)
            put(1, model_axis, msize)
        elif leafname == "mamba_state":            # (ns,per,B,H,P,N)
            if not put(2, dspec, dsize):
                put(4, dspec, dsize)
            put(3, model_axis, msize)
        elif "conv_tails" in p:                    # (ns,per,B,cw-1,C)
            put(2, dspec, dsize)
            put(4, model_axis, msize)
        elif leafname == "wkv_state":              # (L,B,H,K,V)
            if not put(1, dspec, dsize):
                put(3, dspec, dsize)
            put(2, model_axis, msize)
        elif leafname in ("tmix_shift", "cmix_shift"):   # (L,B,1,d)
            put(1, dspec, dsize)
            put(3, model_axis, msize)
        return P(*spec)

    return _map_with_path(rule, cache_shape)


# ---------------------------------------------------------------------------
# ZeRO sharding: additionally shard a replicated dim over the data axes.
# Level 1: optimizer moments (+grad accumulators); level 3: master params
# too (the port then all-gathers them at each step's start).
# ---------------------------------------------------------------------------


def zero_spec(spec: PartitionSpec, shape: Tuple[int, ...], mesh,
              data_axes: Tuple[str, ...]) -> PartitionSpec:
    ax = _axis_sizes(mesh)
    dsize = math.prod(ax[a] for a in data_axes)
    dspec = data_axes if len(data_axes) > 1 else data_axes[0]
    cur = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    # choose the largest unsharded dim divisible by the data-axis size
    best, best_dim = -1, None
    for i, (s, d) in enumerate(zip(shape, cur)):
        if d is None and s % dsize == 0 and s >= dsize and s > best:
            best, best_dim = s, i
    if best_dim is None:
        return spec
    out = list(cur)
    out[best_dim] = dspec
    return P(*out)


def zero_specs(spec_tree: Any, shape_tree: Any, mesh,
               data_axes: Tuple[str, ...]):
    return map_specs(lambda s, sh: zero_spec(s, tuple(sh.shape), mesh,
                                             data_axes),
                     spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# Shardings: specs on a mesh, as DTensor placements
# ---------------------------------------------------------------------------


class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        names = tuple(mesh.axis_names)
        self.dims = [None] * len(names)        # tensor dim per mesh dim
        for dim, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            axes = tuple(a for a in axes if a is not None)
            if [names.index(a) for a in axes] != sorted(
                    names.index(a) for a in axes):
                raise ValueError(f"{spec}: axes of one dim must follow the "
                                 f"mesh order {names}")
            for a in axes:
                self.dims[names.index(a)] = dim

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Replicate() if d is None else Shard(d)
                     for d in self.dims)

    def local_index(self, shape: Tuple[int, ...],
                    coord: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The slice of a tensor of ``shape`` that the device at mesh
        coordinate ``coord`` holds (the reference's
        ``devices_indices_map`` entry for that device)."""
        lo, n = [0] * len(shape), list(shape)
        for mdim, tdim in enumerate(self.dims):   # major to minor
            if tdim is None:
                continue
            size = self.mesh.devices.shape[mdim]
            if n[tdim] % size:
                raise ValueError(f"dim {tdim} of {tuple(shape)} does not "
                                 f"split {size} ways")
            n[tdim] //= size
            lo[tdim] += coord[mdim] * n[tdim]
        return tuple(slice(a, a + b) for a, b in zip(lo, n))

    def place(self, t: torch.Tensor):
        """This rank's share of ``t`` (the same whole tensor on every rank)
        as a DTensor; no communication."""
        from torch.distributed.tensor import DTensor
        local = t[self.local_index(tuple(t.shape), self.mesh.coordinate())]
        return DTensor.from_local(local.contiguous(), self.mesh.device_mesh,
                                  self.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())


def to_shardings(specs: Any, mesh) -> Any:
    return map_specs(lambda s: Sharding(mesh, s), specs)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def is_sharded(tree: Any) -> bool:
    """Whether any leaf of ``tree`` is a DTensor."""
    from repro_torch._tree import paths
    return any(_is_dtensor(t) for _, t in paths(tree))


def place(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` (whole, the same on every rank) as a DTensor
    in its sharding; leaves that require a gradient keep requiring it."""
    def one(t, sh):
        d = sh.place(t.detach())
        return d.requires_grad_() if t.requires_grad else d
    return map_specs(lambda sh, t: one(t, sh), shardings, tree)


def local_tree(tree: Any) -> Any:
    """Each DTensor leaf's local tensor (a view: writes reach the
    DTensor); plain tensors pass through."""
    from repro_torch._tree import paths, unflatten
    return unflatten(tree, [t.to_local() if _is_dtensor(t) else t
                            for _, t in paths(tree)])


def from_local_tree(tree: Any, shardings: Any, like: Any) -> Any:
    """Each leaf of ``tree`` (this rank's shard) as a DTensor of its
    sharding, of the shape and strides of the matching leaf of ``like``
    (the whole tree, e.g. on meta); no communication."""
    from torch.distributed.tensor import DTensor

    def one(sh, t, w):
        return DTensor.from_local(t, sh.mesh.device_mesh, sh.placements,
                                  run_check=False, shape=w.shape,
                                  stride=w.stride())
    return map_specs(one, shardings, tree, like)


def whole(t):
    """The whole tensor of a DTensor leaf (plain tensors pass through).
    Along mesh dims of one rank the local tensor is the whole one: it is
    returned as it is (a view; writes reach the DTensor)."""
    if not _is_dtensor(t):
        return t
    if tuple(t.to_local().shape) == tuple(t.shape):
        return t.to_local()
    return t.full_tensor()


def whole_tree(tree: Any) -> Any:
    from repro_torch._tree import paths, unflatten
    return unflatten(tree, [whole(t) for _, t in paths(tree)])


# ---------------------------------------------------------------------------
# Fabric (multi-device co-verification) layouts: which dim of each op buffer
# is split across the FabricCluster devices (core/fabric.py).  Reduction
# axes are never split, so sharded launches stay bit-identical to one
# device.
# ---------------------------------------------------------------------------

FABRIC_AXIS = "fabric"

FABRIC_OP_SPECS = {
    # C = A @ B: row-shard A and C, replicate B (K is never split)
    "systolic_matmul": {"a": P(FABRIC_AXIS, None), "b": P(None, None),
                        "c": P(FABRIC_AXIS, None)},
    # flash attention, kernel layout (B, H, S, D): heads are independent,
    # so head-sharding q/k/v/o is exact; GQA groups stay device-aligned
    # whenever n_devices divides both H and KH.
    "flash_attention": {"q": P(None, FABRIC_AXIS, None, None),
                        "k": P(None, FABRIC_AXIS, None, None),
                        "v": P(None, FABRIC_AXIS, None, None),
                        "o": P(None, FABRIC_AXIS, None, None)},
}


def fabric_shard_axis(spec: PartitionSpec,
                      axis_name: str = FABRIC_AXIS) -> Optional[int]:
    """Index of the dim a PartitionSpec shards on ``axis_name`` (None when
    the buffer is replicated across the fabric)."""
    for i, s in enumerate(tuple(spec)):
        names = s if isinstance(s, tuple) else (s,)
        if axis_name in [n for n in names if n is not None]:
            return i
    return None
