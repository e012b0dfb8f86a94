"""The port's program profiler (``core/hlo_profiler.py``) against the
reference's ``repro.core.hlo_profiler``.

  * ``profile_hlo``: the port keeps the reference's text parser; on the
    reference's hand-written fixture and on JAX-lowered texts of a scanned
    and a direct program, every field of ``Profile`` is the reference's
    (exact).
  * ``profile_program`` counts one rank's op stream: a 12-iteration
    Python loop counts exactly 12 iterations; the collectives of an
    8-rank fake group (groups of 4) cost what the reference's ring
    formulas give for the same three ops written as HLO (exact); a hand
    count of traffic (exact); llama3.2-1b's smoke forward within 5% of the
    reference's dot FLOPs (its own tolerance in its scan test).
  * ``roofline`` at the reference's constants gives the reference's terms
    (exact), and the port's constants are one H100's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import hlo_profiler as ref_hp
from repro_torch.core import hlo_profiler as hp

torch.set_num_threads(1)

FIXTURE = """
HloModule test

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}

ENTRY %main (p0: f32[128,256]) -> f32[128,256] {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ar = f32[128,256]{1,0} all-reduce(%p0), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = f32[512,256]{1,0} all-gather(%ar), replica_groups=[2,4]<=[8], dimensions={0}
  %sl = f32[128,256]{1,0} slice(%ag), slice={[0:128], [0:256]}
  ROOT %cp = f32[128,256]{1,0} collective-permute(%sl), source_target_pairs={{0,1}}
}
"""

# the three collectives of test_collective_bytes_equal_ring_formulas
COLLECTIVES_HLO = """
HloModule three

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}

ENTRY %main (p0: f32[128,256]) -> (f32[512,256], f32[32,256]) {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ar = f32[128,256]{1,0} all-reduce(%p0), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = f32[512,256]{1,0} all-gather(%ar), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[32,256]{1,0} reduce-scatter(%p0), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  ROOT %t = (f32[512,256]{1,0}, f32[32,256]{1,0}) tuple(%ag, %rs)
}
"""


def _scan_texts():
    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=12)
        return y.sum()

    def direct(x, w):
        return jnp.tanh(x @ w).sum()

    x = jax.ShapeDtypeStruct((32, 64), jnp.float32)
    w = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    return [jax.jit(f).lower(x, w).compile().as_text()
            for f in (scanned, direct)]


def _as_dict(p) -> dict:
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    d["collectives"] = [dataclasses.asdict(c) for c in p.collectives]
    d["dots"] = [dataclasses.asdict(c) for c in p.dots]
    return d


@pytest.mark.parametrize("which", ["fixture", "scanned", "direct"])
def test_profile_hlo_equals_reference(which):
    text = FIXTURE if which == "fixture" else \
        _scan_texts()[which == "direct"]
    world = 8 if which == "fixture" else 1
    got, want = hp.profile_hlo(text, world), ref_hp.profile_hlo(text, world)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _as_dict(got) == _as_dict(want)
    assert [dataclasses.asdict(d) for d in got.top_dots(3)] == \
        [dataclasses.asdict(d) for d in want.top_dots(3)]
    assert [dataclasses.asdict(c) for c in got.top_collectives()] == \
        [dataclasses.asdict(c) for c in want.top_collectives()]
    assert got.collective_summary() == want.collective_summary()


def test_program_loop_counts_every_iteration():
    """12 iterations of ``tanh(c @ w)`` count exactly 12 x one."""
    def loop(c, w, n):
        for _ in range(n):
            c = torch.tanh(c @ w)
        return c

    c, w = torch.randn(32, 64), torch.randn(64, 64)
    twelve = hp.profile_program(loop, c, w, 12)
    one = hp.profile_program(loop, c, w, 1)
    assert one.flops == 2 * 32 * 64 * 64 and one.dot_count == 1
    assert twelve.flops == 12 * one.flops
    assert twelve.traffic_bytes == 12 * one.traffic_bytes
    assert twelve.dot_count == 12
    (rec,) = twelve.dots                      # one call site, 12 calls
    assert rec.multiplier == 12 and rec.total_flops == twelve.flops
    assert rec.jax_path == "test_torch_hlo_profiler.py:loop"
    assert rec.shape == "f32[32,64]"


def _collectives_on_fake_group():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.dryrun import fake_process_group
    with fake_process_group(8):
        group = dist.new_group([0, 1, 2, 3])
        mesh = init_device_mesh("cpu", (2, 4))
        x = torch.empty(128, 256, device="meta")
        d = DTensor.from_local(x, mesh, (Replicate(), Partial()),
                               run_check=False)

        def program():
            y = x.clone()
            dist.all_reduce(y, group=group)
            parts = [torch.empty_like(y) for _ in range(4)]
            dist.all_gather(parts, y, group=group)
            return d.redistribute(mesh, (Replicate(), Shard(0)))
        prof = hp.profile_program(program, world_size=8)
    return prof


def test_collective_bytes_equal_ring_formulas():
    """An all-reduce of f32[128,256], an all-gather to [512,256] (c10d, as
    ``sharding/comm.py`` issues them) and a DTensor ``Partial -> Shard``
    reduce-scatter (``_c10d_functional``) over groups of 4 of an 8-rank
    fake group: the bytes of the reference's ``profile_hlo`` on the same
    three ops as HLO."""
    got = _collectives_on_fake_group()
    want = ref_hp.profile_hlo(COLLECTIVES_HLO, 8)
    assert got.collective_bytes == want.collective_bytes
    assert got.collective_summary() == want.collective_summary()
    key = lambda c: c.kind
    for g, w in zip(sorted(got.collectives, key=key),
                    sorted(want.collectives, key=key)):
        assert (g.kind, g.bytes_full, g.bytes_moved, g.group_size,
                g.multiplier) == (w.kind, w.bytes_full, w.bytes_moved,
                                  w.group_size, w.multiplier)
    assert [c.op_name for c in got.collectives] == [
        "c10d.allreduce_", "c10d.allgather_",
        "_c10d_functional.reduce_scatter_tensor"]


def test_traffic_by_hand():
    """``a @ b + c`` reads its operands and writes its results; a clone
    counts twice its bytes; a transpose is free; an in-place slice write
    and an index write count twice their update."""
    a, b, c = torch.randn(64, 32), torch.randn(32, 16), torch.randn(64, 16)
    x, y = torch.zeros(64, 16), torch.randn(64, 4)
    idx, vals = torch.tensor([1, 5, 9]), torch.randn(3, 16)

    def program():
        z = a @ b + c
        z2 = c.clone()
        t = z.t()
        x[:, 2:6] = y
        x[idx] = vals
        return z2, t

    with hp.ProgramCounter(log_ops=True) as counter:
        program()
    f = 4                                               # bytes a float
    want = {"aten.mm": (64 * 32 + 32 * 16 + 64 * 16) * f,
            "aten.add": 3 * 64 * 16 * f,
            "aten.clone": 2 * 64 * 16 * f,
            "aten.t": 0, "aten.slice": 0,
            "aten.copy_": 2 * 64 * 4 * f,
            "aten.index_put_": 2 * 3 * 16 * f}
    got = {}
    for op, _, _, traffic in counter.ops:
        got[op] = got.get(op, 0) + traffic
    for op, nbytes in want.items():
        assert got.pop(op) == nbytes, op
    assert sum(got.values()) == 0, got            # views, the index tensor
    assert counter.traffic_bytes == sum(want.values())
    assert counter.flops == 2 * 64 * 16 * 32


def test_smoke_forward_dot_flops_within_5pct_of_reference():
    """llama3.2-1b at smoke size, one device, ``chunked`` attention, fp32:
    the port's counted dot FLOPs of its forward against the reference's
    ``profile_hlo`` of ``jit(forward).lower().compile().as_text()``."""
    from repro.configs import get_config as ref_get, smoke as ref_smoke
    from repro.models import transformer as ref_tf
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as tf
    B, S = 2, 128
    rcfg = ref_smoke(ref_get("llama3.2-1b"))
    rflags = ref_tf.RunFlags(attn_impl="chunked", q_chunk=32, kv_chunk=32,
                             compute_dtype="float32")
    params = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    text = jax.jit(lambda p, b: ref_tf.forward(rcfg, p, b, rflags, None)[0]
                   ).lower(params, batch).compile().as_text()
    want = ref_hp.profile_hlo(text, 1).flops

    cfg = smoke(get_config("llama3.2-1b"))
    flags = tf.RunFlags(attn_impl="chunked", q_chunk=32, kv_chunk=32,
                        compute_dtype="float32")
    with torch.device("meta"):
        tparams = tf.init_params(cfg, None, dtype=torch.float32)
    tbatch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                    device="meta")}
    with torch.no_grad():
        got = hp.profile_program(tf.forward, cfg, tparams, tbatch, flags)
    assert got.dot_count > 0
    assert abs(got.flops - want) <= 0.05 * want, (got.flops, want)


def test_roofline_at_reference_constants_equals_reference(monkeypatch):
    prof = hp.Profile(flops=3.1e15, traffic_bytes=2.2e12,
                      collective_bytes=4.7e10, collectives=[], dot_count=7,
                      warnings=[], per_comp_mult={})
    rprof = ref_hp.Profile(flops=3.1e15, traffic_bytes=2.2e12,
                           collective_bytes=4.7e10, collectives=[],
                           dot_count=7, warnings=[], per_comp_mult={})
    # the port's own constants: one H100 SXM5 at 700 W
    assert (hp.PEAK_FLOPS_BF16, hp.HBM_BW, hp.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    terms = hp.roofline(prof, 1.3e15)
    assert terms.compute_s == 3.1e15 / 989e12
    assert terms.memory_s == 2.2e12 / 3.35e12
    assert terms.collective_s == 4.7e10 / 450e9
    assert terms.roofline_fraction == 1.3e15 / 989e12 / terms.bound_s
    monkeypatch.setattr(hp, "PEAK_FLOPS_BF16", ref_hp.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hp, "HBM_BW", ref_hp.HBM_BW)
    monkeypatch.setattr(hp, "NVLINK_BW", ref_hp.ICI_BW_PER_LINK)
    for n_links in (1, 4):
        got = hp.roofline(prof, 1.3e15, n_links)
        want = ref_hp.roofline(rprof, 1.3e15, n_links)
        for f in ("compute_s", "memory_s", "collective_s", "model_flops",
                  "hlo_flops", "dominant", "bound_s", "useful_ratio",
                  "roofline_fraction"):
            assert getattr(got, f) == getattr(want, f), f


def test_meta_run_counts_as_real_run():
    """The dry run counts meta tensors: the same program on real CPU
    tensors and on meta tensors (with and without reused output shapes)
    counts the same FLOPs, traffic and dots."""
    def program(a, b):
        h = torch.relu(a @ b)
        s = torch.softmax(h, dim=-1)
        out = torch.zeros_like(s)
        out[:, :8] = s[:, :8] * 2
        return out.sum(dim=0)

    a, b = torch.randn(16, 32), torch.randn(32, 24)
    runs = []
    for dev, reuse in (("cpu", False), ("meta", False), ("meta", True)):
        args = (a.to(dev), b.to(dev))
        with hp.ProgramCounter(log_ops=True, reuse_shapes=reuse) as c:
            for _ in range(3):
                program(*args)
        runs.append((c.flops, c.traffic_bytes, c.dot_count,
                     [(op, sh) for op, sh, _, _ in c.ops]))
    assert runs[0] == runs[1] == runs[2]


def test_peak_by_site_splits_the_peak():
    """``peak_sites``: the live bytes at the peak split by where each
    storage was made (the tracked arguments apart) sum to the peak within
    the 1 MiB the split may lag it, and name the function that made the
    largest tensor; without it the peak is the same."""
    def big(x):
        return torch.cat([x] * 16)                 # 16 x 256 KiB

    def program(x):
        y = big(x)[:1024].exp()                    # 1 MiB
        return y.sum()

    x = torch.randn(256, 256, device="meta")
    peaks = []
    for sites in (False, True):
        with hp.ProgramCounter(peak_sites=sites) as c:
            held = c.track(x)
            program(x)
        peaks.append(c.peak_bytes)
    assert peaks[0] == peaks[1] > held
    split = c.peak_by_site
    assert split["arguments"] == held
    assert abs(sum(split.values()) - c.peak_bytes) <= 1 << 20
    assert max(split, key=split.get).endswith(
        "test_torch_hlo_profiler.py:big")
