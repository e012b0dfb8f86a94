"""Reusable flash-attention co-verification sweep pieces (kernel layout
B,H,S,D), mirroring kernels/systolic_matmul/sweep.py: one firmware + one
backend table, plus the head-sharded fabric firmware.

Heads are independent in attention, so the fabric layout
(sharding/specs.py "flash_attention": shard q/k/v/o on H) gathers to a
bit-identical result vs the single-device launch whenever the device
count divides both H and KH.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device, to_device
from repro_torch.kernels._compiled import compiled_tier
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.sharding.specs import FABRIC_OP_SPECS


def _inputs(batch: int, heads: int, seq: int, dim: int):
    """Seeded kernel-layout q/k/v (MHA: KH == H)."""
    rng = np.random.default_rng(batch * 7919 + heads * 101 + seq + dim)
    q = rng.normal(size=(batch, heads, seq, dim)).astype(np.float32)
    k = rng.normal(size=(batch, heads, seq, dim)).astype(np.float32)
    v = rng.normal(size=(batch, heads, seq, dim)).astype(np.float32)
    return q, k, v


def flash_backends(bq: int = 32, bk: int = 32, causal: bool = True,
                   device="cuda", jit: bool = True) -> dict:
    """oracle/interpret/compiled backend table for register_op.

    Each backend takes and returns host numpy arrays and owns the copy to
    ``device`` and back.  oracle = torch reference; interpret = the
    hand-written kernel (its plain version when ``device`` is the CPU);
    compiled = with ``jit`` on a CUDA device, the oracle's maths through
    ``torch.compile`` (the twin of the reference's jitted reference, the
    deployment tier), one compiled callable per table, built at its first
    call; else the oracle callable itself, as the reference's ``jit=False``.
    """
    dev = resolve_device(device)

    def on_dev(x):
        return to_device(x, dev)

    def oracle(q, k, v):
        return R.attention_ref(on_dev(q), on_dev(k), on_dev(v),
                               causal=causal).cpu().numpy()

    def interpret(q, k, v):
        out, _ = K.flash_fwd(on_dev(q), on_dev(k), on_dev(v), causal=causal,
                             window=0, bq=bq, bk=bk)
        return out.cpu().numpy()

    compiled = oracle
    if jit and dev.type == "cuda":
        compiled = compiled_tier(R.attention_ref, on_dev, causal=causal)
    return dict(oracle=oracle, interpret=interpret, compiled=compiled)


def flash_firmware(fb, op, backend, *, batch=1, heads=8, seq=64, dim=16,
                   bq: int = 32, bk: int = 32):
    """Single-device host program: alloc/seed q/k/v/o DDR buffers, launch
    with the schedule-derived per-tile burst list (§IV contract)."""
    q, k, v = _inputs(batch, heads, seq, dim)
    for name, arr in (("q", q), ("k", k), ("v", v)):
        fb.mem.alloc(name, arr.shape, np.float32)
        fb.mem.host_write(name, arr)
    fb.mem.alloc("o", q.shape, np.float32)
    fb.launch(op, backend, ["q", "k", "v"], ["o"],
              burst_list=lambda: fa_ops.transactions(
                  batch, heads, seq, seq, dim, bq=bq, bk=bk, causal=True,
                  dtype_bytes=4))


def flash_fabric_firmware(fab, op, backend, *, batch=1, heads=8, seq=64,
                          dim=16, bq: int = 32, bk: int = 32):
    """Head-sharded fabric counterpart of ``flash_firmware`` (same seeded
    data, same host buffer names): scatter q/k/v on H, device-local
    launches with shard-sized burst lists, gather o on H."""
    from repro_torch.core.fabric import sharded_launch

    if heads % fab.n:
        raise ValueError(f"device count {fab.n} must divide heads {heads}")
    q, k, v = _inputs(batch, heads, seq, dim)
    sharded_launch(
        fab, op, backend,
        inputs={"q": q, "k": k, "v": v},
        output=("o", q.shape, np.float32),
        specs=FABRIC_OP_SPECS["flash_attention"],
        burst_list=lambda dev, shapes: fa_ops.transactions(
            batch, shapes["q"][1], seq, seq, dim, bq=bq, bk=bk, causal=True,
            dtype_bytes=4))
