"""Reusable matmul co-verification sweep pieces (paper Fig. 5 cells).

One firmware + one backend table for the systolic matmul, plus the
row-sharded fabric firmware.  The firmware signature is
``firmware(fb, op, backend, **config)``.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device, to_device
from repro_torch.kernels._compiled import compiled_tier
from repro_torch.kernels.systolic_matmul import ops as mm_ops, ref as mm_ref
from repro_torch.sharding.specs import FABRIC_OP_SPECS


def matmul_firmware(fb, op, backend, *, size, tile: int = 32):
    """Host-side program for one sweep cell: alloc/seed DDR, launch the
    matmul with its per-tile burst list (§IV data-movement contract)."""
    rng = np.random.default_rng(size)
    a = rng.normal(size=(size, size)).astype(np.float32)
    b = rng.normal(size=(size, size)).astype(np.float32)
    fb.mem.alloc("a", a.shape, np.float32)
    fb.mem.alloc("b", b.shape, np.float32)
    fb.mem.alloc("c", (size, size), np.float32)
    fb.mem.host_write("a", a)
    fb.mem.host_write("b", b)
    fb.launch(op, backend, ["a", "b"], ["c"],
              burst_list=lambda: mm_ops.transactions(
                  size, size, size, bm=tile, bn=tile, bk=tile,
                  dtype_bytes=4))


def matmul_fabric_firmware(fab, op, backend, *, size, tile: int = 32):
    """Sharded fabric counterpart of ``matmul_firmware`` (same seeded data,
    same host buffer names): row-shard A/C across the cluster, broadcast B
    — the ``sharding/specs.py`` "systolic_matmul" fabric layout — then
    gather C.  K is never split, so the gathered C is bit-identical to the
    single-device launch of the same backend.
    """
    from repro_torch.core.fabric import sharded_launch

    rng = np.random.default_rng(size)
    a = rng.normal(size=(size, size)).astype(np.float32)
    b = rng.normal(size=(size, size)).astype(np.float32)
    sharded_launch(
        fab, op, backend,
        inputs={"a": a, "b": b},
        output=("c", (size, size), np.float32),
        specs=FABRIC_OP_SPECS["systolic_matmul"],
        burst_list=lambda dev, shapes: mm_ops.transactions(
            shapes["c"][0], size, size,
            bm=min(tile, shapes["c"][0]), bn=tile, bk=tile, dtype_bytes=4))


def matmul_backends(tile: int = 32, device="cuda", jit: bool = True) -> dict:
    """oracle/interpret/compiled backend table for register_op.

    Each backend takes and returns host numpy arrays (the bridge's DDR)
    and owns the copy to ``device`` and back.  oracle = fp32 torch
    reference; interpret = the hand-written kernel (its plain version when
    ``device`` is the CPU); compiled = with ``jit`` on a CUDA device, the
    oracle's maths through ``torch.compile`` (the twin of the reference's
    ``jax.jit``), one compiled callable per table, built at its first call;
    else the oracle callable itself, as the reference's ``jit=False``.
    """
    dev = resolve_device(device)

    def on_dev(x):
        return to_device(x, dev)

    def oracle(x, y):
        return mm_ref.matmul_ref(on_dev(x), on_dev(y)).cpu().numpy()

    def interpret(x, y):
        return mm_ops.matmul(on_dev(x), on_dev(y), bm=tile, bn=tile,
                             bk=tile).cpu().numpy()

    compiled = oracle
    if jit and dev.type == "cuda":
        compiled = compiled_tier(mm_ref.matmul_ref, on_dev)
    return dict(oracle=oracle, interpret=interpret, compiled=compiled)
