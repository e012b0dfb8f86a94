"""The port's sweep scheduler (``repro_torch/core/scheduler.py``) vs the
JAX reference's, on the CPU, and the three thread-safety repairs that a
thread-pooled sweep needs (``_device.true_fp32``, ``kernels/_build.load``,
``kernels/_compiled.compiled_tier``).

The reference runs ``jit=False`` backend tables (Pallas in interpret mode),
as its own tests run it on the CPU; the port runs with ``device="cpu"``,
where the matmul kernel's wrapper takes its plain version.  Value-free
artefacts of one sweep built the same way on both sides — ``to_rows(wall=
False)``, ``scaling()`` and ``summary()`` without their wall columns, each
cell's counter digests and fault trace, the merged coverage counts, the
counter mismatches — must be EQUAL; cell outputs agree within the
reference's matmul tolerance, 1e-4 * max(1, max|ref|).  No test here
asserts on wall-clock time.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.kernels.systolic_matmul.sweep as ref_mm
import repro_torch.core as port_core
import repro_torch.kernels.systolic_matmul.sweep as port_mm
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.mamba2_scan import ops as ref_ssd_ops
from repro.kernels.rwkv6_wkv import ops as ref_wkv_ops
from repro_torch import _device
from repro_torch.core.scheduler import _config_key
from repro_torch.kernels import _build, _compiled
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

torch.set_num_threads(1)

_firmware = port_mm.matmul_firmware


def _table(**kw):
    return port_mm.matmul_backends(device="cpu", jit=False, **kw)


def _session(bug: bool = False, congestion=None):
    table = _table()

    def interp(a, b):
        out = np.array(table["interpret"](a, b))
        if bug:
            out[1, 2] += 1.0                  # injected hardware bug
        return out

    sess = port_core.CoVerifySession(_firmware, congestion=congestion)
    sess.register_op("mm", oracle=table["oracle"], interpret=interp)
    return sess


# ------------------------------------------------ the reference's cases
def test_sweep_runs_all_cells_and_groups():
    sess = _session()
    cells = sess.add_sweep("mm", ("oracle", "interpret"),
                           [{"size": 32}, {"size": 64}])
    assert len(cells) == 4
    report = sess.run(max_workers=2)
    assert report.passed
    assert len(report.cells) == 4
    assert len(report.equivalence) == 2       # one group per config
    assert all(r.seconds > 0 for r in report.cells)
    assert report.summary()["cells"] == 4
    assert len(report.to_rows()) == 5         # header + 4 cells


def test_sweep_localizes_divergence_per_group():
    sess = _session(bug=True)
    sess.add_sweep("mm", ("oracle", "interpret"), [{"size": 32}])
    report = sess.run()
    assert not report.passed
    (eq,) = report.equivalence.values()
    d = eq.divergences[0]
    assert d.leaf_path == "c" and d.index == (1, 2)
    assert abs(d.max_abs_err - 1.0) < 1e-3


def test_sweep_cells_carry_online_congestion():
    cong = port_core.CongestionConfig(seed=3, priorities=(("dma_a", 1),))
    sess = _session(congestion=cong)
    sess.add_sweep("mm", ("oracle",), [{"size": 64}])
    (r,) = sess.run().cells
    assert r.congestion is not None and r.congestion.makespan > 0
    assert sum(r.congestion.per_engine_stall.values()) > 0
    assert r.bridge_time >= r.congestion.makespan


def test_config_key_groups_equal_ndarray_configs():
    def firmware(fb, op, backend, *, scale):
        fb.mem.alloc("c", scale.shape, np.float32)
        fb.launch(op, backend, [], ["c"], scale=scale)

    eye = np.eye(2, dtype=np.float32)
    table = _table()
    sess = port_core.CoVerifySession(firmware)
    sess.register_op("sc", oracle=lambda scale: scale @ eye,
                     interpret=lambda scale: table["oracle"](scale, eye))
    sess.add_cell("sc", "oracle", {"scale": np.ones((2, 2), np.float32)})
    sess.add_cell("sc", "interpret", {"scale": np.ones((2, 2), np.float32)})
    report = sess.run(max_workers=1)
    (eq,) = report.equivalence.values()
    assert set(eq.backends) == {"oracle", "interpret"}
    big_a = {"scale": np.arange(4000, dtype=np.float32)}
    big_b = {"scale": np.arange(4000, dtype=np.float32)}
    big_b["scale"][2000] += 1.0          # differs deep inside the "..."
    assert _config_key(big_a) != _config_key(big_b)
    assert _config_key(big_a) == _config_key(
        {"scale": np.arange(4000, dtype=np.float32)})


def test_config_key_groups_equal_dataclass_configs():
    @dataclasses.dataclass
    class Tile:
        bm: int
        weights: np.ndarray

    a = {"tile": Tile(32, np.ones(3, np.float32))}
    b = {"tile": Tile(32, np.ones(3, np.float32))}
    c = {"tile": Tile(32, np.zeros(3, np.float32))}
    assert _config_key(a) == _config_key(b)
    assert _config_key(a) != _config_key(c)
    assert _config_key({"x": [np.ones(2), 3]}) == \
        _config_key({"x": [np.ones(2), 3]})
    assert _config_key({"x": np.float32("nan")}) == \
        _config_key({"x": np.float32("nan")})
    assert _config_key({"x": np.float32(1)}) != \
        _config_key({"x": np.float64(1)})


def test_config_key_equals_reference():
    from repro.core.scheduler import _config_key as ref_key
    cfgs = [{"size": 64, "tile": 32}, {"x": [np.ones(2), 3]},
            {"x": np.float32("nan")}, {"s": np.arange(4000.0)}]
    for cfg in cfgs:
        assert _config_key(cfg) == ref_key(cfg)


def test_cell_error_is_contained():
    sess = _session()
    sess.register_op("boom", oracle=lambda *a: (_ for _ in ()).throw(
        RuntimeError("dead op")))
    sess.add_cell("mm", "oracle", {"size": 32})
    sess.add_cell("boom", "oracle", {"size": 32})
    report = sess.run(max_workers=2)
    assert not report.passed
    errs = [r for r in report.cells if r.error]
    assert len(errs) == 1 and "dead op" in errs[0].error


def test_add_cell_rejects_unknown_op():
    with pytest.raises(KeyError):
        _session().add_cell("nope", "oracle")


def test_sequential_and_batched_agree():
    sess = _session()
    sess.add_sweep("mm", ("oracle", "interpret"),
                   [{"size": 32}, {"size": 64}])
    seq = port_core.run_sequential(sess)
    bat = sess.run(max_workers=4)
    assert seq.passed and bat.passed
    for a, b in zip(seq.cells, bat.cells):
        assert a.cell.label == b.cell.label
        for name in a.outputs:
            np.testing.assert_array_equal(a.outputs[name], b.outputs[name])


def test_report_is_independent_of_thread_completion_order():
    """A seeded 20-cell sweep (faults, online congestion, a coverage sink,
    one planted divergence): rows, verdicts, divergence attachments and
    the merged coverage are the same at ``max_workers`` 1 and 8."""
    configs = ([{"size": 32, "tile": t} for t in (4, 8, 16, 32)]
               + [{"size": 64, "tile": t} for t in (8, 16, 32, 64)]
               + [{"size": 96, "tile": 32}, {"size": 96, "tile": 48}])

    def run(max_workers):
        table = _table()

        def interp(a, b):
            out = np.array(table["interpret"](a, b))
            if out.shape[0] == 96:
                out[1, 2] += 1.0          # planted divergence, size-96 only
            return out

        cov = port_core.CoverageModel()
        sess = port_core.CoVerifySession(
            _firmware, congestion=port_core.CongestionConfig(seed=7),
            fault_plan=port_core.FaultPlan(seed=11), coverage=cov)
        sess.register_op("mm", oracle=table["oracle"], interpret=interp)
        assert len(sess.add_sweep("mm", ("oracle", "interpret"),
                                  configs)) == 20
        return sess.run(max_workers=max_workers), cov

    seq, cov_seq = run(1)
    par, cov_par = run(8)
    assert seq.to_rows(wall=False) == par.to_rows(wall=False)
    s, p = seq.summary(), par.summary()
    for k in ("cells", "groups", "passed", "failures", "divergences"):
        assert s[k] == p[k], k
    assert not seq.passed and len(s["divergences"]) == 2
    assert [[e.key() for e in r.faults] for r in seq.cells] == \
        [[e.key() for e in r.faults] for r in par.cells]
    assert cov_seq.counts == cov_par.counts
    assert sum(cov_seq.counts["fault_kind"].values()) > 0
    assert seq.coverage is cov_seq and par.coverage is cov_par


_BURSTS = {
    "flash": (fa_ops, ref_fa_ops, lambda m: m.transactions(
        2, 4, 256, 256, 64, bq=128, bk=128, causal=True, dtype_bytes=2)),
    "ssd": (ssd_ops, ref_ssd_ops, lambda m: m.transactions(
        2, 256, 16, 32, 64, chunk=128, hb=8)),
    "wkv": (wkv_ops, ref_wkv_ops, lambda m: m.transactions(
        2, 64, 16, 32, chunk=16, hb=8)),
}


@pytest.mark.parametrize("name", sorted(_BURSTS))
def test_burst_lists_per_tile_equal_reference(name):
    """The kernels' per-tile burst lists (what the bridge arbitrates) are
    the reference's tuples, with the reference's per-tile properties."""
    port_mod, ref_mod, call = _BURSTS[name]
    txs = call(port_mod)
    assert txs == call(ref_mod)
    assert all(nb > 0 and addr >= 0 for _, _, addr, nb in txs)
    assert len({e for e, _, _, _ in txs}) >= 4
    assert {k for _, k, _, _ in txs} == {"read", "write"}
    if name == "flash":
        assert max(nb for _, _, _, nb in txs) == 128 * 64 * 2
    else:
        assert sum(e == "dma_state" for e, _, _, _ in txs) == 2 * (16 // 8)


# --------------------------------------------------- parity with the JAX side
def _parity_session(core, mm, devices: bool, profile: bool, **kw):
    common = dict(congestion=core.CongestionConfig(dos_prob=0.02, seed=11),
                  fault_plan=core.FaultPlan(0), profile=profile,
                  coverage=core.CoverageModel())
    if devices:
        sess = core.CoVerifySession(
            mm.matmul_firmware, fabric_firmware=mm.matmul_fabric_firmware,
            link_config=core.FABRIC_LINK, **common)
    else:
        sess = core.CoVerifySession(mm.matmul_firmware, **common)
    sess.register_op("mm", **mm.matmul_backends(tile=32, jit=False, **kw))
    backends = ("oracle", "interpret", "compiled")
    if devices:
        sess.add_sweep("mm", backends, [{"size": 64, "tile": 32}],
                       devices=(1, 2, 4), topologies=("ring",))
    else:
        sess.add_sweep("mm", backends, [{"size": 64, "tile": 32},
                                        {"size": 96, "tile": 32}])
    return sess


_WALL = ("wall_seconds", "cell_seconds_sum")


@pytest.mark.parametrize("devices", [False, True], ids=["sizes", "devices"])
@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profiled"])
def test_sweep_artefacts_equal_reference(devices, profile):
    """Sizes 64 / 96 (tile 32) or a 1/2/4-device sweep with ring cells,
    three backends, congestion with DoS and a fault plan, with and
    without the profile columns: the port's value-free artefacts are the
    reference's, and its outputs within the matmul tolerance."""
    port = _parity_session(port_core, port_mm, devices, profile,
                           device="cpu").run(max_workers=4)
    ref = _parity_session(ref_core, ref_mm, devices, profile).run(
        max_workers=1)                   # its rows hold at any worker count
    assert port.passed and ref.passed, port.summary()
    assert port.to_rows(wall=False) == ref.to_rows(wall=False)
    cut = lambda rows: [r.rsplit(",", 1)[0] for r in rows]  # noqa: E731
    assert cut(port.scaling()) == cut(ref.scaling())
    ps, rs = port.summary(), ref.summary()
    assert {k: v for k, v in ps.items() if k not in _WALL} == \
        {k: v for k, v in rs.items() if k not in _WALL}
    for p, r in zip(port.cells, ref.cells):
        assert p.cell.label == r.cell.label
        for k in ("digest", "functional", "totals", "timing_key"):
            assert p.counters[k] == r.counters[k], (p.cell.label, k)
        assert [e.key() for e in p.faults] == [e.key() for e in r.faults]
        assert p.bridge_time == r.bridge_time
        for name, arr in r.outputs.items():
            assert np.abs(p.outputs[name] - arr).max() <= 1e-4 * max(
                1.0, float(np.abs(arr).max())), (p.cell.label, name)
        if profile:
            assert p.profile.engine_rows() == r.profile.engine_rows()
    assert port.coverage.counts == ref.coverage.counts
    assert port.counter_mismatches == ref.counter_mismatches == {}
    if devices:
        by = {r.cell.group_member: r.outputs["c"] for r in port.cells}
        for member, out in by.items():
            if member.startswith("interpret@"):
                np.testing.assert_array_equal(out, by["interpret"])


def test_fabric_cells_equal_across_worker_counts():
    """The devices sweep's rows are the same at 1 and 4 workers."""
    rows = [_parity_session(port_core, port_mm, True, True,
                            device="cpu").run(max_workers=n)
            .to_rows(wall=False) for n in (1, 4)]
    assert rows[0] == rows[1]


# ------------------------------------- thread-safety repairs of the port
def test_true_fp32_is_reentrant_across_threads():
    """Two threads interleave enter and exit (A in, B in, A out, B out):
    inside either context TF32 is off, and after both exit the flag is
    what it was before.  A save-and-restore per context restored A's
    saved ``True`` while B still computed."""
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    flag.allow_tf32 = True
    seen = {}
    b_in, a_out = threading.Event(), threading.Event()

    def thread_a():
        with _device.true_fp32():
            seen["a_in"] = flag.allow_tf32
            b_in.wait(5)
        a_out.set()

    def thread_b():
        with _device.true_fp32():
            b_in.set()
            a_out.wait(5)
            seen["b_after_a_left"] = flag.allow_tf32

    try:
        ta = threading.Thread(target=thread_a)
        ta.start()
        while "a_in" not in seen:
            time.sleep(0.001)
        tb = threading.Thread(target=thread_b)
        tb.start()
        ta.join(10)
        tb.join(10)
        assert not (ta.is_alive() or tb.is_alive())
        assert seen == {"a_in": False, "b_after_a_left": False}
        assert flag.allow_tf32 is True
        with _device.true_fp32():            # nests in one thread too
            with _device.true_fp32():
                assert flag.allow_tf32 is False
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = saved


def test_build_load_builds_once_under_threads(monkeypatch):
    """Eight threads that ``load`` one kernel at once build it once."""
    calls = {"start": 0, "finish": 0}
    sentinel = object()

    def start(name):
        calls["start"] += 1
        time.sleep(0.05)                       # a compile takes a while
        return None, None, None

    def finish(name, out, proc, tmp):
        calls["finish"] += 1
        _build._libs[name] = sentinel
        return sentinel

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish", finish)
    monkeypatch.setattr(_build, "_libs", {})
    go = threading.Barrier(8)
    got = []

    def worker():
        go.wait()
        got.append(_build.load("systolic_matmul"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"start": 1, "finish": 1}
    assert got == [sentinel] * 8


def test_compiled_tier_first_call_runs_alone(monkeypatch):
    """Eight threads call one fresh ``compiled_tier`` callable at once: at
    most one is inside the compiled function before its first call for
    those shapes has returned; later calls run side by side."""
    state = {"inside": 0, "most": 0, "done": 0, "most_after": 0}
    mu = threading.Lock()

    def fake_compile(fn, **kw):
        def run(*xs):
            with mu:
                state["inside"] += 1
                key = "most" if state["done"] == 0 else "most_after"
                state[key] = max(state[key], state["inside"])
            time.sleep(0.05)
            try:
                return fn(*xs)
            finally:
                with mu:
                    state["inside"] -= 1
                    state["done"] += 1
        return run

    monkeypatch.setattr(torch, "compile", fake_compile)
    fn = _compiled.compiled_tier(lambda a, b: a @ b, torch.from_numpy)
    x = np.eye(4, dtype=np.float32)
    go = threading.Barrier(8)
    outs = []

    def worker():
        go.wait()
        outs.append(fn(x, x))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 8 and all(np.array_equal(o, x) for o in outs)
    assert state["most"] == 1 and state["done"] == 8
