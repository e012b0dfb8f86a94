"""The port's multi-device fabric (``repro_torch/core/{topology,switch,
fabric}.py``, ``sharding/specs.py``, the two fabric firmwares) vs the JAX
reference, on the CPU.

Both packages get the same seeds.  The reference runs ``jit=False``
backend tables (Pallas in interpret mode), as its own tests run it on the
CPU; the port runs with ``device="cpu"``.  Value-free artefacts — the
committed fabric traces and torus counters, routes and hop counts, fabric
and device log digests, fault traces, clocks, counter streams — must be
EQUAL.  Gathered results are held to 1e-4 * max(1, max|ref|) against the
reference (fp32 on both sides, sums in other orders) and must be
bit-identical to the port's own 1-device run: the layouts never split a
reduction axis.
"""
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.counters as ref_counters
import repro.core.topology as ref_topo
import repro.kernels.flash_attention.sweep as ref_fa
import repro.kernels.systolic_matmul.sweep as ref_mm
import repro.sharding.specs as ref_specs
import repro_torch.core as port_core
import repro_torch.core.counters as port_counters
import repro_torch.core.topology as port_topo
import repro_torch.kernels.flash_attention.sweep as port_fa
import repro_torch.kernels.systolic_matmul.sweep as port_mm
import repro_torch.sharding.specs as port_specs
from repro_torch import goldens
from repro_torch.convert import fabric_state_from_reference

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
LINK = dict(link_bytes_per_cycle=64.0, base_latency=100.0,
            max_burst_bytes=4096, dos_prob=0.05, seed=11)
CONG = dict(dos_prob=0.05, seed=7)

FABRIC_GOLDENS = [("fabric_all_reduce", "trace"),
                  ("fabric_batched_launch", "trace"),
                  ("fabric_torus_all_reduce", "trace"),
                  ("fabric_torus_all_reduce", "counters")]


@pytest.mark.parametrize("name,kind", FABRIC_GOLDENS,
                         ids=[f"{n}.{k}" for n, k in FABRIC_GOLDENS])
def test_port_regenerates_fabric_golden(name, kind):
    target = goldens.PROGRAMS[name]("cpu")
    live = (goldens.trace_lines(target) if kind == "trace"
            else goldens.counter_lines(target))
    path = GOLDEN / f"{name}.{kind}"
    assert live == path.read_text().splitlines()
    assert hashlib.sha256(("\n".join(live) + "\n").encode()).hexdigest() == \
        hashlib.sha256(path.read_bytes()).hexdigest()


# ------------------------------------------------------------- topologies
def _topology(mod, kind, n):
    if kind == "fat_tree_narrow":
        return mod.fat_tree(n, leaf_width=2, spines=2)
    if kind == "ring_credit1":
        return mod.ring(n, credits=1, flit_bytes=128)
    return mod.build_topology(kind, n)


@pytest.mark.parametrize("kind", ["ring", "torus2d", "fat_tree",
                                  "fat_tree_narrow", "ring_credit1"])
@pytest.mark.parametrize("n", [4, 8])
def test_routes_and_hops_equal_reference(kind, n):
    ref, port = _topology(ref_topo, kind, n), _topology(port_topo, kind, n)
    for field in ("kind", "n_devices", "n_switches", "attach", "edges",
                  "host_attach", "flit_bytes", "credits"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.groups() == ref.groups()
    for s in range(n):
        for d in range(n):
            assert port.route(s, d) == ref.route(s, d), (s, d)
            assert port.n_hops(s, d) == ref.n_hops(s, d)
    for a in range(port.n_switches):
        for b in range(port.n_switches):
            assert port.route_switches(a, b) == ref.route_switches(a, b)
    assert [port.edge_label(k) for k in range(len(port.edges))] == \
        [ref.edge_label(k) for k in range(len(ref.edges))]


def test_topology_registry_and_refusals_match_reference():
    assert port_topo.TOPOLOGY_KINDS == ref_topo.TOPOLOGY_KINDS
    msgs = []
    for mod, core in ((ref_topo, ref_core), (port_topo, port_core)):
        got = []
        for call in (lambda: mod.build_topology("mesh3d", 4),
                     lambda: mod.Topology("bad", 2, 1, (0,), ()),
                     lambda: mod.Topology("bad", 1, 1, (0,), ((0, 1),)),
                     lambda: mod.Topology("bad", 2, 2, (0, 1), ()).route(0, 1),
                     lambda: mod.torus2d(10, rows=4),
                     lambda: core.FabricCluster(4, topology=mod.ring(8)),
                     lambda: core.FabricCluster(0)):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_credit_window_and_switch_seeds_like_reference():
    out = []
    for core in (ref_core, port_core):
        p = core.SwitchPort("sw0->sw1", core.CongestionConfig(), credits=2)
        trace = [p.acquire(10.0)]
        p.release([50.0, 80.0])
        trace.append(p.acquire(20.0))
        p.release([120.0])
        trace += [list(p._inflight), p.acquire(90.0), p.credit_stall,
                  p.credit_waits, p.credit_grants]
        sw = core.SwitchFabric(core.ring(4),
                               core.CongestionConfig(dos_prob=0.2, seed=3))
        trace.append([q.link.cfg.seed for q in sw.ports])
        trace.append([q.label for q in sw.route_ports("h", 2)])
        out.append(trace)
    assert out[0] == out[1]


def test_fabric_specs_equal_reference():
    assert port_specs.FABRIC_AXIS == ref_specs.FABRIC_AXIS
    assert set(port_specs.FABRIC_OP_SPECS) == set(ref_specs.FABRIC_OP_SPECS)
    for op, specs in ref_specs.FABRIC_OP_SPECS.items():
        for name, spec in specs.items():
            mine = port_specs.FABRIC_OP_SPECS[op][name]
            assert tuple(mine) == tuple(spec)
            assert port_specs.fabric_shard_axis(mine) == \
                ref_specs.fabric_shard_axis(spec)
    P = port_specs.PartitionSpec
    assert port_specs.fabric_shard_axis(P(None, ("data", "fabric"))) == 1
    assert port_specs.fabric_shard_axis(P(None, "model")) is None
    assert port_specs.fabric_shard_axis(P()) is None


# --------------------------------------------------------- sharded launch
CELLS = {
    "matmul": (ref_mm.matmul_fabric_firmware,
               lambda: ref_mm.matmul_backends(tile=16, jit=False),
               port_mm.matmul_fabric_firmware,
               lambda: port_mm.matmul_backends(tile=16, device="cpu"),
               dict(size=64, tile=16), "c"),
    "flash": (ref_fa.flash_fabric_firmware,
              lambda: ref_fa.flash_backends(jit=False),
              port_fa.flash_fabric_firmware,
              lambda: port_fa.flash_backends(device="cpu"),
              dict(), "o"),
}


def _sharded(core, firmware, table, n, backend, cfg, topology=None):
    fab = core.FabricCluster(
        n, congestion=core.CongestionConfig(**CONG),
        link_config=core.CongestionConfig(**LINK),
        fault_plan=core.FaultPlan(seed=3), topology=topology)
    fab.register_op("op", **table)
    firmware(fab, "op", backend, **cfg)
    return fab


@pytest.mark.parametrize("backend", ["oracle", "interpret", "compiled"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sharded_launch_equals_reference(cell, backend):
    """1, 2 and 4 devices: fabric and device digests, fault traces, clocks
    and counters equal to the reference's; the gathered result within
    tolerance of the reference's and bit-identical to the port's own
    1-device run."""
    ref_fw, ref_tab, port_fw, port_tab, cfg, out = CELLS[cell]
    ref_table, port_table = ref_tab(), port_tab()
    one = None
    for n in (1, 2, 4):
        ref = _sharded(ref_core, ref_fw, ref_table, n, backend, cfg)
        port = _sharded(port_core, port_fw, port_table, n, backend, cfg)
        assert port.digest() == ref.digest(), n
        assert [d.log.digest() for d in port.devices] == \
            [d.log.digest() for d in ref.devices]
        assert [e.key() for e in port.fault_events()] == \
            [e.key() for e in ref.fault_events()]
        assert port.time == ref.time
        assert [d.mem.time for d in port.devices] == \
            [d.mem.time for d in ref.devices]
        assert port.total_link_stall() == ref.total_link_stall()
        assert (port_counters.merged_digest(port.counter_banks())
                == ref_counters.merged_digest(ref.counter_banks()))
        assert str(port.device_congestion()) == str(ref.device_congestion())
        got, want = port.outputs()[out], ref.outputs()[out]
        assert np.abs(got - want).max() <= 1e-4 * max(
            1.0, float(np.abs(want).max()))
        one = got if one is None else one
        assert np.array_equal(got, one), n
        if n > 1:
            assert port.total_link_stall() > 0


@pytest.mark.parametrize("kind", ["ring", "torus2d"])
def test_routed_sharded_launch_equals_reference(kind):
    ref_fw, ref_tab, port_fw, port_tab, cfg, out = CELLS["matmul"]
    ref = _sharded(ref_core, ref_fw, ref_tab(), 4, "oracle", cfg, kind)
    port = _sharded(port_core, port_fw, port_tab(), 4, "oracle", cfg, kind)
    assert port.digest() == ref.digest()
    assert port.switch.port_stats() == ref.switch.port_stats()
    assert port.switch.total_credit_stall() == ref.switch.total_credit_stall()
    crossbar = _sharded(port_core, port_fw, port_tab(), 4, "oracle", cfg)
    assert np.array_equal(port.outputs()[out], crossbar.outputs()[out])
    assert port.time != crossbar.time


def test_routed_fabric_closes_interconnect_coverage():
    """The run of the reference's coverage test: one short routed copy per
    topology kind (plus the crossbar default) closes topology and hops; a
    credits=1 ring broadcast closes credit_stall.  Counts equal the
    reference's."""
    counts = []
    for core, topo in ((ref_core, ref_topo), (port_core, port_topo)):
        cov = core.CoverageModel()
        core.FabricCluster(1, coverage=cov)

        def run(topology, src, dst):
            fab = core.FabricCluster(topology.n_devices, coverage=cov,
                                     topology=topology)
            fab.alloc_sharded("x", (64,), np.float32, axis=None)
            fab.dev_copy(src, dst, "x")

        run(topo.fat_tree(4, leaf_width=4), 0, 1)
        run(topo.ring(4), 0, 1)
        run(topo.torus2d(8), 0, 5)
        run(topo.ring(8), 0, 4)
        fab = core.FabricCluster(4, coverage=cov,
                                 topology=topo.ring(4, credits=1))
        fab.host.alloc("b", (4096,), np.float32)
        fab.broadcast("b")
        for g in ("topology", "hops", "credit_stall"):
            assert cov.covered(g), cov.holes(g)
        assert cov.counts["credit_stall"]["waited"] > 0
        counts.append(cov.counts)
    assert counts[0] == counts[1]


def test_fabric_operations_feed_coverage_like_reference():
    counts = []
    for core in (ref_core, port_core):
        cov = core.CoverageModel()
        fab = core.FabricCluster(3, link_config=core.CongestionConfig(**LINK),
                                 coverage=cov)
        data = np.arange(7 * 6, dtype=np.float32).reshape(7, 6)
        fab.host.alloc("x", data.shape, np.float32)
        fab.host.host_write("x", data)
        fab.scatter("x", axis=1)
        fab.gather("x", axis=1)
        fab.host.alloc("y", data.shape, np.float32)
        fab.host.host_write("y", data)
        fab.broadcast("y")
        fab.all_reduce("y", "max")
        fab.dev_copy(0, 1, "x", dst_name="x2")
        assert np.array_equal(fab.outputs()["x"], data)
        assert cov.covered("fabric")
        counts.append(cov.counts)
    assert counts[0] == counts[1]


# ------------------------------------------------------ state hand-over
def _batched_cluster(core, table):
    fab = core.FabricCluster(3, congestion=core.CongestionConfig(**CONG),
                             link_config=core.CongestionConfig(**LINK),
                             fault_plan=core.FaultPlan(seed=13))
    fab.register_op("mm", **table)
    return fab


def _batched_head(fab):
    rng = np.random.default_rng(21)
    act = rng.normal(size=(48, 48)).astype(np.float32)
    wts = rng.normal(size=(48, 48)).astype(np.float32)
    for name, arr in (("act", act), ("act2", act), ("wts", wts)):
        fab.host.alloc(name, arr.shape, np.float32)
        fab.host.host_write(name, arr)
    fab.scatter("act", axis=0)
    fab.scatter("act2", axis=1)
    fab.broadcast("wts")


def _batched_tail(fab):
    for i in range(3):
        fab.devices[i].mem.alloc("out", (16, 48), np.float32)
        fab.launch(i, "mm", "oracle", ["act", "wts"], ["out"])
    fab.gather("out", axis=0)
    fab.dev_copy(0, 2, "act", dst_name="act_copy")
    fab.all_reduce("act", "sum")
    fab.collect_replicated("wts")


def _torus_cluster(core, table):
    return core.FabricCluster(8, link_config=core.CongestionConfig(**LINK),
                              fault_plan=core.FaultPlan(seed=13),
                              topology="torus2d")


def _torus_head(fab):
    rng = np.random.default_rng(29)
    act = rng.normal(size=(32, 32)).astype(np.float32)
    fab.host.alloc("act", act.shape, np.float32)
    fab.host.host_write("act", act)
    fab.scatter("act", axis=0)
    for i in range(8):
        fab.devices[i].mem.alloc("grad", (16, 16), np.float32)
        fab.devices[i].mem.host_write(
            "grad", np.full((16, 16), float(i + 1), np.float32))


def _torus_tail(fab):
    fab.all_reduce("grad", "sum")
    fab.dev_copy(0, 5, "grad", dst_name="grad_copy")
    fab.gather("act", axis=0)
    fab.host.alloc("wts", (16, 16), np.float32)
    fab.host.host_write("wts", np.ones((16, 16), np.float32))
    fab.broadcast("wts")
    fab.collect_replicated("wts")


HANDOVER = {"crossbar_batched": (_batched_cluster, _batched_head,
                                 _batched_tail),
            "torus2d_routed": (_torus_cluster, _torus_head, _torus_tail)}


@pytest.mark.parametrize("case", sorted(HANDOVER))
def test_fabric_state_handover_mid_program(case):
    """Snapshot the reference's cluster mid-program (device bridges with
    their forked fault plans, fabric log, links, switch ports with their
    credit windows, the fabric-link plan, counters), load it into the
    port, continue both: digests, fault traces, clocks and counters end
    up equal, and the gathered values agree."""
    build, head, tail = HANDOVER[case]
    ref = build(ref_core, ref_mm.matmul_backends(tile=16, jit=False))
    head(ref)
    snap = ref.get_state()
    port = build(port_core, port_mm.matmul_backends(tile=16, device="cpu"))
    port.set_state(fabric_state_from_reference(snap))
    assert port.digest() == ref.digest()
    assert port.time == ref.time
    tail(ref)
    tail(port)
    assert port.digest() == ref.digest()
    assert port.log.canonical() == ref.log.canonical()
    assert [e.key() for e in port.fault_events()] == \
        [e.key() for e in ref.fault_events()]
    assert type(port.fault_events()[0]).__module__.startswith("repro_torch")
    assert port.time == ref.time
    assert [d.mem.time for d in port.devices] == \
        [d.mem.time for d in ref.devices]
    assert [b.canonical() for b in port.counter_banks()] == \
        [b.canonical() for b in ref.counter_banks()]
    assert port.total_link_stall() == ref.total_link_stall()
    if port.switch is not None:
        assert port.switch.port_stats() == ref.switch.port_stats()
    for name, arr in ref.outputs().items():
        got = port.outputs()[name]
        assert np.abs(got - arr).max() <= 1e-4 * max(
            1.0, float(np.abs(arr).max())), name
    # the converted snapshot shares no mutable state with the reference
    assert port.host.buffers["act"].array is not \
        ref.host.buffers["act"].array


def test_profiler_raises_naming_item_8():
    """``FabricCluster.profiler()`` (the name dates from when it raised)
    profiles: a 2-device sharded matmul with a DoS link gives the
    reference's channels, per-port and per-engine rows, per-op (collective
    leg and launch) rows and Perfetto bytes, and every channel's
    attribution closes to its horizon."""
    import json

    def run(core, mm, **kw):
        fab = core.FabricCluster(2, link_config=core.CongestionConfig(
            **LINK), profile=True)
        fab.register_op("mm", **mm.matmul_backends(tile=16, jit=False,
                                                   **kw))
        mm.matmul_fabric_firmware(fab, "mm", "oracle", size=32, tile=16)
        fab.all_reduce("c")
        return fab.profiler()

    port = run(port_core, port_mm, device="cpu")
    ref = run(ref_core, ref_mm)
    assert [c.name for c in port.channels] == [c.name for c in ref.channels]
    assert "fabric/port1" in [c.name for c in port.channels]
    assert port.engine_rows() == ref.engine_rows()
    assert port.op_rows() == ref.op_rows()
    assert len(port.op_rows()) > 3
    for ch in port.channels:                 # the left fold closes
        total = 0.0
        for c in port_core.CATEGORIES:
            total += ch.breakdown.cycles[c]
        assert total == ch.horizon, ch.name
    dump = lambda p: json.dumps(p.to_perfetto(), sort_keys=True,  # noqa
                                separators=(",", ":"))
    assert dump(port) == dump(ref)
