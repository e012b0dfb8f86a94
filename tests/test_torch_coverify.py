"""The first slice of the PyTorch port as a whole vs the JAX reference:
``coverify()`` through the congestion-arbitrated bridge, the equivalence
checker, the committed single-device goldens and the state hand-over.

Both packages get the same seeded firmware.  The JAX side runs as its own
tests run it on the CPU (``jit=False`` backend tables, Pallas in interpret
mode); the port runs with ``device="cpu"``.  Value-free artefacts
(transaction summaries, log digests, counter streams, clocks, divergence
coordinates, leaf paths) must be EQUAL.  DDR buffer values are held to
1e-4 * max(1, max|ref|): fp32 accumulation on both sides, summed in
different orders.
"""
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.counters as ref_counters
import repro.core.equivalence as ref_eq
import repro.kernels.flash_attention.sweep as ref_fa
import repro.kernels.systolic_matmul.sweep as ref_mm
import repro_torch.core as port_core
import repro_torch.core.counters as port_counters
import repro_torch.core.equivalence as port_eq
import repro_torch.kernels.flash_attention.sweep as port_fa
import repro_torch.kernels.systolic_matmul.sweep as port_mm
from repro_torch.convert import (bridge_state_from_reference,
                                 params_from_reference)

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
CONG = dict(dos_prob=0.05, seed=7)

CELLS = {
    "matmul32": (
        lambda fb, be: ref_mm.matmul_firmware(fb, "op", be, size=32, tile=16),
        lambda: ref_mm.matmul_backends(tile=16, jit=False),
        lambda fb, be: port_mm.matmul_firmware(fb, "op", be, size=32, tile=16),
        lambda: port_mm.matmul_backends(tile=16, device="cpu")),
    "matmul96": (
        lambda fb, be: ref_mm.matmul_firmware(fb, "op", be, size=96, tile=32),
        lambda: ref_mm.matmul_backends(tile=32, jit=False),
        lambda fb, be: port_mm.matmul_firmware(fb, "op", be, size=96, tile=32),
        lambda: port_mm.matmul_backends(tile=32, device="cpu")),
    "flash": (
        lambda fb, be: ref_fa.flash_firmware(fb, "op", be),
        lambda: ref_fa.flash_backends(jit=False),
        lambda fb, be: port_fa.flash_firmware(fb, "op", be),
        lambda: port_fa.flash_backends(device="cpu")),
}


def _coverify(core, firmware, table):
    bridges = {}

    def fw(fb, be):
        bridges[be] = fb
        firmware(fb, be)

    res = core.coverify(fw, {"op": table}, tol=1e-3,
                        congestion=core.CongestionConfig(**CONG))
    return res, bridges


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_coverify_slice_matches_reference(cell):
    ref_fw, ref_table, port_fw, port_table = CELLS[cell]
    r_res, r_fb = _coverify(ref_core, ref_fw, ref_table())
    p_res, p_fb = _coverify(port_core, port_fw, port_table())
    assert r_res.passed and p_res.passed
    assert str(p_res.equivalence) == str(r_res.equivalence)
    assert "EQUIVALENT" in str(p_res.equivalence)
    assert p_res.protocol_violations == r_res.protocol_violations == []
    assert p_res.tx_summary == r_res.tx_summary
    assert p_res.congestion.summary() == r_res.congestion.summary()
    assert list(p_fb) == list(r_fb) == ["oracle", "interpret", "compiled"]
    for be in r_fb:
        assert p_fb[be].log.digest() == r_fb[be].log.digest()
        assert p_fb[be].mem.time == r_fb[be].mem.time
        for name, buf in r_fb[be].mem.buffers.items():
            got = p_fb[be].mem.buffers[name]
            assert got.addr == buf.addr and got.array.shape == buf.array.shape
            tol = 1e-4 * max(1.0, float(np.abs(buf.array).max()))
            assert np.abs(got.array - buf.array).max() < tol, (be, name)
    # the transaction stream does not depend on the backend
    assert len({fb.log.digest() for fb in p_fb.values()}) == 1


def _bug_cell(core, mm_sweep, table):
    def interp(a, b):
        out = np.array(table["interpret"](a, b))
        out[3, 7] += 0.5                  # injected hardware bug
        return out

    ops = {"mm": dict(oracle=table["oracle"], interpret=interp)}
    return core.coverify(
        lambda fb, be: mm_sweep.matmul_firmware(fb, "mm", be, size=64,
                                                tile=32),
        ops, backends=("oracle", "interpret"), tol=1e-4)


def test_planted_bug_localised_like_reference():
    r = _bug_cell(ref_core, ref_mm, ref_mm.matmul_backends(32, jit=False))
    p = _bug_cell(port_core, port_mm, port_mm.matmul_backends(32, device="cpu"))
    assert not r.passed and not p.passed
    dr, dp = r.equivalence.divergences[0], p.equivalence.divergences[0]
    assert dp.leaf_path == dr.leaf_path == "c"
    assert dp.index == dr.index == (3, 7)
    assert dp.pair == dr.pair
    assert abs(dp.max_abs_err - 0.5) < 1e-3
    assert str(p.equivalence).splitlines()[0] == \
        str(r.equivalence).splitlines()[0]


TREE = {"w": [np.arange(3.0), (np.ones((2, 2)), np.zeros(1))],
        "a": {"z": np.float32(1.5), "b": np.arange(4), "n": None},
        "m": (np.ones(2, np.int32),), 3: np.ones(1)}


def test_flattener_leaf_paths_match_jax():
    tree = {k: v for k, v in TREE.items() if k != 3}
    want = ref_eq._leaf_paths(tree)
    got = port_eq._leaf_paths(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [p for p, _ in got] == ["a/b", "a/z", "m/0", "w/0", "w/1/0",
                                   "w/1/1"]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    assert port_eq._leaf_paths(np.ones(2))[0][0] == \
        ref_eq._leaf_paths(np.ones(2))[0][0] == "<root>"


def test_flattener_takes_tensors_and_compare_agrees():
    a = {"x": [torch.ones(2, 3), np.zeros(2)], "y": torch.ones(2).bfloat16()}
    b = {"x": [np.ones((2, 3)), np.zeros(2)], "y": np.ones(2)}
    assert port_eq.compare(a, b, ("a", "b"), 1e-6) is None
    b["x"][0][1, 2] = 2.0
    d = port_eq.compare(a, b, ("a", "b"), 1e-6)
    dr = ref_eq.compare({"x": [np.ones((2, 3)), np.zeros(2)],
                         "y": np.ones(2)}, b, ("a", "b"), 1e-6)
    assert (d.leaf_path, d.index, d.lhs, d.rhs, d.max_abs_err) == \
        (dr.leaf_path, dr.index, dr.lhs, dr.rhs, dr.max_abs_err)
    assert d.leaf_path == "x/0" and d.index == (1, 2)
    rep = port_eq.check_equivalence(
        {"a": lambda: {"x": np.zeros((2, 2))},
         "b": lambda: {"x": np.zeros((2, 3))}}, (), tol=1e-6)
    assert not rep.passed and "DIVERGENT" in str(rep)


def test_params_from_reference_keeps_nesting_and_paths():
    tree = {k: v for k, v in TREE.items() if k != 3}
    out = params_from_reference(tree, device="cpu")
    assert isinstance(out["w"], list) and isinstance(out["w"][1], tuple)
    assert out["a"]["n"] is None
    assert all(isinstance(leaf, torch.Tensor)
               for _, leaf in port_eq._flatten_with_path(out))
    assert [p for p, _ in port_eq._leaf_paths(out)] == \
        [p for p, _ in ref_eq._leaf_paths(tree)]
    assert port_eq.compare(out, tree, ("port", "ref"), 0.0) is None
    with pytest.raises(RuntimeError):
        params_from_reference(tree, device="cuda")


def _golden_program(core, mm_sweep, table):
    fb = core.FireBridge(congestion=core.CongestionConfig(**CONG))
    fb.register_op("mm", **table)
    mm_sweep.matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    return fb


@pytest.mark.parametrize("kind", ["trace", "counters"])
def test_port_regenerates_single_device_golden(kind):
    fb = _golden_program(port_core, port_mm,
                         port_mm.matmul_backends(tile=16, device="cpu"))
    if kind == "trace":
        live = fb.log.canonical()
    else:
        live = [ln for bank in port_counters.counter_banks(fb)
                for ln in bank.canonical()]
    path = GOLDEN / f"single_device_launch.{kind}"
    assert live == path.read_text().splitlines()
    assert hashlib.sha256(("\n".join(live) + "\n").encode()).hexdigest() == \
        hashlib.sha256(path.read_bytes()).hexdigest()


def _step(fb, i):
    """One more firmware step on an existing bridge: CSR traffic, a fresh
    buffer, a launch with a burst list."""
    fb.csr.fb_write_32(0x0, i)
    fb.csr.fb_read_32(0x40)                      # unmapped: a violation
    name = f"d{i}"
    fb.mem.alloc(name, (32, 32), np.float32)
    fb.launch("mm", "interpret", ["a", "b"], [name],
              burst_list=lambda: [("dma_a", "read", 64 * k, 512 + i)
                                  for k in range(24)])


def test_bridge_state_handover_mid_program():
    """Snapshot the reference mid-program, load it into the port, continue
    on both: digests, clocks, counters and arbiter state end up equal."""
    ref = _golden_program(ref_core, ref_mm,
                          ref_mm.matmul_backends(tile=16, jit=False))
    ref.csr.define("CTRL", 0x0)
    _step(ref, 1)
    snap = ref.get_state()

    port = port_core.FireBridge(
        congestion=port_core.CongestionConfig(**CONG))
    port.register_op("mm", **port_mm.matmul_backends(tile=16, device="cpu"))
    port.csr.define("CTRL", 0x0)
    port.set_state(bridge_state_from_reference(snap))
    assert port.log.digest() == ref.log.digest()
    assert port.mem.time == ref.mem.time and port.csr.time == ref.csr.time

    for i in (2, 3):
        _step(ref, i)
        _step(port, i)
    assert port.log.digest() == ref.log.digest()
    assert port.log.canonical() == ref.log.canonical()
    assert port.mem.time == ref.mem.time and port.csr.time == ref.csr.time
    assert port.mem._next == ref.mem._next
    assert (port.mem.counters.canonical() == ref.mem.counters.canonical())
    assert (port_counters.merged_digest(port.counter_banks())
            == ref_counters.merged_digest(ref.counter_banks()))
    assert port.congestion_stats().summary() == \
        ref.congestion_stats().summary()
    assert (port.mem.link.get_state()["rng"]
            == ref.mem.link.get_state()["rng"])
    assert port.csr.get_state() == ref.csr.get_state()
    for name, buf in ref.mem.buffers.items():
        assert np.abs(port.mem.buffers[name].array - buf.array).max() < 1e-4
    # the converted snapshot shares no mutable state with the reference's
    assert port.mem.buffers["a"].array is not ref.mem.buffers["a"].array
    assert type(port.log.txs[0]).__module__.startswith("repro_torch")


def test_bridge_state_handover_carries_fault_plan():
    """A snapshot taken under a fault plan: the plan's bit-generator state
    and its events come across, so the port injects the reference's
    remaining fault stream — the same audit lines, fault events, digests
    and clocks after both continue."""
    def build(core, table):
        fb = core.FireBridge(congestion=core.CongestionConfig(**CONG),
                             fault_plan=core.FaultPlan(seed=13))
        fb.register_op("mm", **table)
        fb.csr.define("CTRL", 0x0)
        return fb

    ref = build(ref_core, ref_mm.matmul_backends(tile=16, jit=False))
    ref_mm.matmul_firmware(ref, "mm", "oracle", size=32, tile=16)
    _step(ref, 1)
    ref.mem.dev_read("a")                      # a read the plan may flip
    snap = ref.get_state()
    assert snap["mem"]["fault_plan"]["events"]

    port = build(port_core, port_mm.matmul_backends(tile=16, device="cpu"))
    port.set_state(bridge_state_from_reference(snap))
    plan = port.mem.fault_plan
    assert plan.rng.bit_generator.state == \
        ref.mem.fault_plan.rng.bit_generator.state
    assert [e.key() for e in plan.events] == \
        [e.key() for e in ref.mem.fault_plan.events]
    assert type(plan.events[0]).__module__.startswith("repro_torch")
    assert port.log.digest() == ref.log.digest()

    for i in (2, 3, 4):
        for fb in (ref, port):
            _step(fb, i)
            fb.mem.dev_read(f"d{i}")
    assert port.log.digest() == ref.log.digest()
    assert list(port.log.faults) == list(ref.log.faults)
    assert [e.key() for e in plan.events] == \
        [e.key() for e in ref.mem.fault_plan.events]
    assert len(plan.events) > len(snap["mem"]["fault_plan"]["events"])
    assert port.mem.time == ref.mem.time and port.csr.time == ref.csr.time
    assert (port_counters.merged_digest(port.counter_banks())
            == ref_counters.merged_digest(ref.counter_banks()))
    # the converted plan shares no state with the reference's
    assert plan.events is not ref.mem.fault_plan.events


def test_port_bridge_refusals_match_reference():
    msgs = []
    for core in (ref_core, port_core):
        fb = core.FireBridge()
        fb.mem.alloc("x", (4,), np.float32)
        fb.register_op("two", oracle=lambda x: (x, x))
        got = []
        for call in (lambda: fb.mem.alloc("x", (4,), np.float32),
                     lambda: fb.mem.host_write("x", np.zeros(3)),
                     lambda: fb.mem.dev_write("x", np.zeros((2, 2))),
                     lambda: fb.launch("two", "oracle", ["x"], ["x"])):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    # the profiler, queued until replay and profiling were ported, is there
    # on both sides and profiles a fresh bridge alike
    rows = [core.FireBridge().profiler().engine_rows()
            for core in (ref_core, port_core)]
    assert rows[0] == rows[1]
