"""Fabric (multi-device co-verification) layouts: which dim of each op
buffer is split across the ``FabricCluster`` devices (core/fabric.py).

A layout is a ``PartitionSpec``: one entry per dim, each an axis name, a
tuple of axis names, or None (that dim is not split).  The port keeps its
own small spec type, so the fabric needs no device-mesh library; it has
the reference's vocabulary (``PartitionSpec(FABRIC_AXIS, None)``).
Reduction axes are never split, so sharded launches stay bit-identical to
one device.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A tuple of per-dim axis names (``None`` = replicated dim)."""

    def __new__(cls, *axes: Axis) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

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
