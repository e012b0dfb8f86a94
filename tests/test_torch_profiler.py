"""The port's off-chip data-movement profiler (``repro_torch/core/
profiler.py``) vs the JAX reference's, on the CPU.

The profiler is host code over modeled cycles: for the same run its
channels, rows and exported Perfetto files carry no tensor values, so they
must be EQUAL to the reference's byte for byte.  The reference's golden
runs are its recorded golden programs (``tests/test_golden_traces.py``);
the port's are ``repro_torch/goldens.py``'s direct programs.  Closure —
every channel's six categories, folded left in taxonomy order, summing
bit-exactly to its horizon, which for a single device is ``bridge.time``
— is asserted on every profile.  No test here asserts on wall-clock
time.
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.kernels.systolic_matmul.ops as ref_mm_ops
import repro.kernels.systolic_matmul.sweep as ref_mm
import repro_torch.core as port_core
import repro_torch.kernels.systolic_matmul.ops as port_mm_ops
import repro_torch.kernels.systolic_matmul.sweep as port_mm
from repro_torch import goldens
from repro_torch.core import (CATEGORIES, DataMovementProfiler,
                              RooflinePlacement, profile_recording,
                              profile_window, validate_trace)
from repro_torch.core import replay as rp

sys.path.insert(0, str(Path(__file__).resolve().parent))

torch.set_num_threads(1)

SIDES = {"port": (port_core, port_mm, port_mm_ops, dict(device="cpu")),
         "ref": (ref_core, ref_mm, ref_mm_ops, {})}
FLAGS = dict(attn_impl="chunked", q_chunk=16, kv_chunk=16,
             compute_dtype="float32")


def _fold(cycles) -> float:
    """The left fold in taxonomy order — the sum the profiler closes
    (Python 3.12's ``sum`` of floats is compensated, another sum)."""
    s = 0.0
    for c in CATEGORIES:
        s += cycles[c]
    return s


def _assert_closed(prof) -> None:
    assert prof.channels, "profiler resolved no channels"
    for ch in prof.channels:
        bd = ch.breakdown
        assert set(bd.cycles) == set(CATEGORIES)
        assert _fold(bd.cycles) == ch.horizon == bd.total, ch.name
        assert all(v >= -1e-6 for v in bd.cycles.values()), ch.name
        assert ch.residual < 1e-3, (ch.name, ch.residual)


def _bytes(prof, tmp_path, name) -> bytes:
    return prof.save_perfetto(tmp_path / name).read_bytes()


# ------------------------------------------------------- golden-run parity
@pytest.mark.parametrize("name", sorted(goldens.PROGRAMS))
def test_golden_programs_perfetto_equal_reference(name, tmp_path):
    """For every golden program the port's Perfetto file is the
    reference's byte for byte; attribution closes, on a single device to
    ``bridge.time``; the trace validates."""
    import test_golden_traces as tg
    target = goldens.PROGRAMS[name]("cpu")
    prof = DataMovementProfiler(target, label=name)
    _assert_closed(prof)
    if isinstance(target, port_core.FireBridge):
        assert prof.channel("ddr").horizon == target.mem.time
    ref = ref_core.DataMovementProfiler(tg.TRACES[name]().recording.target,
                                        label=name)
    assert _bytes(prof, tmp_path, "port.json") == \
        _bytes(ref, tmp_path, "ref.json")
    assert prof.engine_rows() == ref.engine_rows()
    assert prof.summary() == ref.summary()
    assert validate_trace(prof.to_perfetto()) == []


# ------------------------------------------------------------- one bridge
def _profiled_run(side="port", profile=True):
    core, mm, ops, kw = SIDES[side]
    fb = core.FireBridge(congestion=core.CongestionConfig(dos_prob=0.05,
                                                          seed=7),
                         fault_plan=core.FaultPlan(3), profile=profile)
    fb.register_op("mm", **mm.matmul_backends(tile=16, jit=False, **kw))
    mm.matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    rng = np.random.default_rng(48)
    a = rng.normal(size=(48, 48)).astype(np.float32)
    fb.mem.alloc("a2", a.shape, np.float32)
    fb.mem.alloc("c2", (48, 48), np.float32)
    fb.mem.host_write("a2", a)
    fb.launch("mm", "oracle", ["a2", "a2"], ["c2"],
              burst_list=lambda: ops.transactions(
                  48, 48, 48, bm=16, bn=16, bk=16, dtype_bytes=4))
    return fb


def test_export_deterministic_and_equal_reference(tmp_path):
    p1 = _bytes(_profiled_run().profiler(), tmp_path, "a.json")
    p2 = _bytes(_profiled_run().profiler(), tmp_path, "b.json")
    assert p1 == p2 and p1.endswith(b"\n")
    assert p1 == _bytes(_profiled_run("ref").profiler(), tmp_path, "r.json")


def test_op_marks_and_engine_rows():
    fb = _profiled_run()
    prof = fb.profiler()
    _assert_closed(prof)
    assert [m.op for _, m in prof.marks] == ["mm@oracle", "mm@oracle"]
    assert all(m.tx_hi > m.tx_lo for _, m in prof.marks)
    rows = prof.op_rows()
    assert rows[0].startswith("op,meta,transactions,bytes") and len(rows) == 3
    res = fb.congestion_stats()
    ddr = prof.channel("ddr")
    for e, s in ddr.engines.items():
        assert s.stall == res.per_engine_stall[e]
        assert s.busy == res.per_engine_busy[e]
    assert ddr.utilization == res.link_utilization
    assert ddr.horizon == res.makespan == fb.mem.time
    ref = _profiled_run("ref").profiler()
    assert prof.engine_rows() == ref.engine_rows()
    assert rows == ref.op_rows()


def test_fault_delay_attributed():
    fb = _profiled_run()
    ddr = fb.profiler().channel("ddr")
    if any(e.kind == "dma_delay" for e in fb.mem.fault_plan.events):
        assert ddr.breakdown.cycles["fault_delay"] > 0
    assert sum(s.fault_delay for s in ddr.engines.values()) > 0


def test_fast_path_closure_and_schema():
    fb = port_core.FireBridge(profile=True)
    fb.register_op("mm", **port_mm.matmul_backends(tile=16, jit=False,
                                                   device="cpu"))
    port_mm.matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    prof = fb.profiler()
    _assert_closed(prof)
    ddr = prof.channel("ddr")
    assert ddr.kind == "clock" and ddr.horizon == fb.mem.time
    assert validate_trace(prof.to_perfetto()) == []


def test_validate_trace_gives_reference_messages():
    """The reference's bad traces (a missing key, a skewed attribution, a
    wrong top level, an unknown phase, a bad ts) get the reference's
    messages, word for word."""
    good = _profiled_run().profiler().to_perfetto()
    assert validate_trace(good) == []
    bad = []
    broken = json.loads(json.dumps(good))
    del broken["traceEvents"][0]["name"]
    bad.append(broken)
    skewed = json.loads(json.dumps(good))
    skewed["otherData"]["attribution"]["ddr"]["transfer"] += 1.0
    bad.append(skewed)
    bad.append({"traceEvents": []})
    odd = json.loads(json.dumps(good))
    odd["traceEvents"][3]["ph"] = "Q"
    odd["traceEvents"][5]["ts"] = -3.0
    del odd["otherData"]["horizons"]["csr"]
    bad.append(odd)
    for trace in bad:
        got = validate_trace(trace)
        assert got and got == ref_core.validate_trace(trace)
    assert any("missing" in e for e in validate_trace(broken))
    assert any("sums to" in e for e in validate_trace(skewed))


def test_roofline_placement_terms():
    pl = RooflinePlacement("k", {"compute": 2.0, "memory": 4.0}, ideal_s=1.0)
    assert pl.dominant == "memory" and pl.limit_s == 4.0
    assert pl.roofline_frac == 0.25
    assert RooflinePlacement("z", {"compute": 0.0}).roofline_frac == 0.0


def test_profiler_roofline_uses_marked_bytes():
    prof = _profiled_run().profiler()
    pts = prof.roofline({"mm@oracle": 1e6}, peak_flops=1e9, mem_bw=1e8)
    ref = _profiled_run("ref").profiler().roofline(
        {"mm@oracle": 1e6}, peak_flops=1e9, mem_bw=1e8)
    assert len(pts) == 2 and [p.terms for p in pts] == [p.terms for p in ref]
    assert all(p.terms["memory"] > 0 for p in pts)


def test_unknown_target_is_refused():
    with pytest.raises(TypeError, match="no profiling mapping"):
        DataMovementProfiler(object())


# ---------------------------------------------------------------- fabric
def _fabric(side):
    core = SIDES[side][0]
    fab = core.FabricCluster(4, profile=True, link_config=core.CongestionConfig(
        link_bytes_per_cycle=64.0, base_latency=100.0, dos_prob=0.05,
        seed=11))
    for i in range(4):
        fab.devices[i].mem.alloc("g", (16, 16), np.float32)
        fab.devices[i].mem.host_write(
            "g", np.full((16, 16), float(i + 1), np.float32))
    fab.all_reduce("g")
    return fab.profiler()


def test_fabric_profile_ports_and_leg_attribution(tmp_path):
    prof = _fabric("port")
    _assert_closed(prof)
    names = [c.name for c in prof.channels]
    assert "fabric/host" in names
    assert all(f"fabric/port{i}" in names for i in range(4))
    assert [(m.op, m.meta) for _, m in prof.marks] == \
        [("all_reduce", f"{phase}[{s}]")
         for phase in ("reduce_scatter", "all_gather") for s in range(3)]
    rows = prof.op_rows()
    assert len(rows) == 7 and all(int(r.split(",")[3]) > 0 for r in rows[1:])
    ref = _fabric("ref")
    assert rows == ref.op_rows() and prof.engine_rows() == ref.engine_rows()
    assert _bytes(prof, tmp_path, "p") == _bytes(ref, tmp_path, "r")
    assert validate_trace(prof.to_perfetto()) == []


def test_routed_fabric_profiles_every_switch_port():
    """A ring-routed cluster: one channel per switch port, each closing,
    the reference's names and rows."""
    out = {}
    for side in ("port", "ref"):
        core, mm, _, kw = SIDES[side]
        fab = core.FabricCluster(4, link_config=core.FABRIC_LINK,
                                 profile=True, topology="ring")
        fab.register_op("mm", **mm.matmul_backends(tile=16, jit=False,
                                                   **kw))
        mm.matmul_fabric_firmware(fab, "mm", "oracle", size=32, tile=16)
        out[side] = fab.profiler()
    _assert_closed(out["port"])
    names = [c.name for c in out["port"].channels]
    assert names == [c.name for c in out["ref"].channels]
    assert sum(n.startswith("fabric/") for n in names) > 5
    assert out["port"].engine_rows() == out["ref"].engine_rows()
    assert out["port"].op_rows() == out["ref"].op_rows()


# ------------------------------------------------------ recording profiling
def _recorded_bridge():
    table = port_mm.matmul_backends(tile=16, jit=False, device="cpu")

    def factory():
        fb = port_core.FireBridge(
            congestion=port_core.CongestionConfig(dos_prob=0.05, seed=7),
            fault_plan=port_core.FaultPlan(3))
        fb.register_op("mm", **table)
        return fb

    def program(rec):
        for j, size in enumerate([32, 48, 32, 64]):
            rng = np.random.default_rng(size * 7 + j)
            a = rng.normal(size=(size, size)).astype(np.float32)
            rec.do("alloc", f"a{j}", a.shape, np.float32)
            rec.do("alloc", f"c{j}", (size, size), np.float32)
            rec.do("host_write", f"a{j}", a)
            rec.do("launch", "mm", "oracle", (f"a{j}", f"a{j}"),
                   (f"c{j}",), "mm",
                   (lambda s=size: port_mm_ops.transactions(
                       s, s, s, bm=16, bn=16, bk=16, dtype_bytes=4)), {})

    sess = rp.DebugSession(factory, checkpoint_interval=4, label="prof")
    return sess, sess.record(program)


def test_profile_recording_matches_original():
    sess, rec = _recorded_bridge()
    orig = DataMovementProfiler(rec.target, label="prof")
    replayed = profile_recording(sess, rec)
    _assert_closed(replayed)
    assert json.dumps(orig.to_perfetto(), sort_keys=True) == \
        json.dumps(replayed.to_perfetto(), sort_keys=True)


def test_profile_window_replay_identity():
    sess, rec = _recorded_bridge()
    for lo, hi in [(0, rec.n_ops), (5, 12), (3, 9), (10, rec.n_ops)]:
        w = sess.replay(rec, lo, hi)
        assert profile_window(w.target, rec, lo, hi) == \
            profile_window(rec.target, rec, lo, hi), (lo, hi)
    assert profile_window(rec.target, rec, 0, rec.n_ops)


# ------------------------------------------------------------ sweep wiring
def test_sweep_cells_close_and_report_columns(tmp_path):
    out = {}
    for side in ("port", "ref"):
        core, mm, _, kw = SIDES[side]
        sess = core.CoVerifySession(
            mm.matmul_firmware,
            congestion=core.CongestionConfig(dos_prob=0.02, seed=5),
            fault_plan=core.FaultPlan(9), profile=True)
        sess.register_op("mm", **mm.matmul_backends(tile=32, jit=False,
                                                    **kw))
        sess.add_sweep("mm", ("oracle", "interpret"), [{"size": 64}])
        out[side] = sess.run(max_workers=2 if side == "port" else 1)
    rep = out["port"]
    assert rep.passed, rep.summary()
    for r in rep.cells:
        _assert_closed(r.profile)
        assert r.profile.channel("ddr").horizon == r.bridge_time
        assert 0.0 < r.utilization <= 1.0 and sum(r.attribution.values()) > 0
    rows = rep.to_rows()
    assert "utilization" in rows[0]
    assert all(f"{c}_cycles" in rows[0] for c in CATEGORIES)
    assert "-" not in rows[1].split(",")
    assert rep.to_rows(wall=False) == out["ref"].to_rows(wall=False)
    paths = rep.save_traces(tmp_path / "port")
    ref_paths = out["ref"].save_traces(tmp_path / "ref")
    assert [p.name for p in paths] == [p.name for p in ref_paths]
    for p, q in zip(paths, ref_paths):
        assert validate_trace(json.loads(p.read_text())) == []
        assert p.read_bytes() == q.read_bytes()


def test_unprofiled_sweep_keeps_dash_columns():
    sess = port_core.CoVerifySession(port_mm.matmul_firmware)
    sess.register_op("mm", **port_mm.matmul_backends(tile=32, jit=False,
                                                     device="cpu"))
    sess.add_cell("mm", "oracle", {"size": 64})
    rep = sess.run(max_workers=1)
    assert rep.passed
    (r,) = rep.cells
    assert r.profile is None and r.utilization is None
    assert ",-," in rep.to_rows()[1]
    assert rep.save_traces("unused") == []


def test_fabric_sweep_cells_close():
    link = port_core.CongestionConfig(link_bytes_per_cycle=64.0,
                                      base_latency=100.0)
    sess = port_core.CoVerifySession(
        port_mm.matmul_firmware,
        fabric_firmware=port_mm.matmul_fabric_firmware, link_config=link,
        profile=True)
    sess.register_op("mm", **port_mm.matmul_backends(tile=32, jit=False,
                                                     device="cpu"))
    sess.add_sweep("mm", ("oracle",), [{"size": 64}], devices=(1, 2, 4))
    rep = sess.run(max_workers=2)
    assert rep.passed, rep.summary()
    for r in rep.cells:
        _assert_closed(r.profile)
        assert max(c.horizon for c in r.profile.channels) == r.bridge_time


# ---------------------------------------------------------- serving profile
@pytest.fixture(scope="module")
def engines():
    """Continuous-batching fp32 engines of ``_default_engine``'s geometry,
    the port's weights carried from the reference."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import smoke as ref_smoke
    from repro.models import transformer as ref_tf
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.configs import get_config, smoke
    from repro_torch.convert import params_from_reference
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    rcfg = ref_smoke(ref_get_config("llama3.2-1b"))
    cfg = smoke(get_config("llama3.2-1b"))
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    kw = dict(max_slots=3, max_len=32, prompt_pad=8)
    return {"ref": RefEngine(rcfg, rparams, flags=ref_tf.RunFlags(**FLAGS),
                             **kw),
            "port": ServingEngine(cfg, tparams, flags=tf.RunFlags(**FLAGS),
                                  device="cpu", **kw)}


def test_serving_profiler_splits_upload_vs_writeback(engines, tmp_path):
    """A storm through the CSR doorbell: prompt uploads and token
    writebacks split (one read a submit, one row a retire), the
    reference's rows and Perfetto bytes."""
    profs = {}
    for side, eng in engines.items():
        eng.reset(batching="storm", kv_pages=None)
        for rid, n in ((0, 6), (1, 9)):
            eng.mem.buffers["prompt_in"].array[:n] = \
                np.arange(n, dtype=np.int32) + 1
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_ID"), rid)
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_LEN"), n)
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_MAXNEW"), 3)
            eng.csr.fb_write_32(eng.csr.addr_of("DOORBELL"), 1)
        eng.run_until_done()
        profs[side] = eng.profiler()
    prof = profs["port"]
    _assert_closed(prof)
    by = {r.split(",")[0]: r.split(",") for r in prof.serving_rows()[1:]}
    assert int(by["prompt_upload"][2]) > 0 and int(by["prompt_upload"][1]) == 2
    assert int(by["token_writeback"][2]) > 0 and \
        int(by["token_writeback"][1]) == 2
    assert prof.serving_rows() == profs["ref"].serving_rows()
    assert prof.engine_rows() == profs["ref"].engine_rows()
    assert _bytes(prof, tmp_path, "p") == _bytes(profs["ref"], tmp_path, "r")
    assert validate_trace(prof.to_perfetto()) == []


def test_serving_request_rows_equal_reference(engines, tmp_path):
    """An open-loop run under KV-page admission: per-request lifecycle
    rows (queue / prefill / decode in modeled cycles) and the request
    tracks of the export are the reference's."""
    from repro.serving.arrivals import poisson_trace as ref_trace
    from repro_torch.serving.arrivals import poisson_trace, run_open_loop
    from repro.serving.arrivals import run_open_loop as ref_run
    profs = {}
    for side, eng in engines.items():
        eng.reset(batching="continuous", kv_pages=4, kv_page_size=8,
                  kv_leak_every=0)
        mk, run = ((poisson_trace, run_open_loop) if side == "port"
                   else (ref_trace, ref_run))
        run(eng, mk(3, n_requests=6, mean_gap=150.0, prompt_lens=(3, 10),
                    max_new=(1, 4)))
        profs[side] = eng.profiler("openloop")
    prof = profs["port"]
    _assert_closed(prof)
    assert len(prof.requests) == 6 and len(prof.request_rows()) == 7
    assert prof.request_rows() == profs["ref"].request_rows()
    assert prof.serving_rows() == profs["ref"].serving_rows()
    cats = {e.get("cat") for e in prof.to_perfetto()["traceEvents"]}
    assert {"prefill", "decode"} <= cats
    assert _bytes(prof, tmp_path, "p") == _bytes(profs["ref"], tmp_path, "r")


def test_closure_where_the_reference_stays_open():
    """A 4-device cell whose d2 DDR channel the reference leaves one ulp
    short of its horizon: its carrier walk steps over the total from
    either side.  The port then walks the fold's last term from the exact
    remainder and closes.  Rows and Perfetto events stay the reference's;
    the exported attribution differs by that term's ulps only (a negative
    zero where the reference's unclosed term rounds to zero)."""
    out = {}
    for side in ("port", "ref"):
        core, mm, _, kw = SIDES[side]
        sess = core.CoVerifySession(
            mm.matmul_firmware, fabric_firmware=mm.matmul_fabric_firmware,
            congestion=core.CongestionConfig(dos_prob=0.05, seed=7),
            link_config=core.CongestionConfig(
                link_bytes_per_cycle=64.0, base_latency=100.0,
                max_burst_bytes=4096, dos_prob=0.05, seed=11),
            fault_plan=core.FaultPlan(0), profile=True)
        sess.register_op("mm", **mm.matmul_backends(tile=16, jit=False,
                                                    **kw))
        sess.add_cell("mm", "compiled", {"size": 32, "tile": 16}, devices=4)
        out[side] = sess.run(max_workers=1).cells[0].profile
    ref_ch = out["ref"].channel("d2/ddr")
    assert _fold(ref_ch.breakdown.cycles) != ref_ch.horizon
    _assert_closed(out["port"])
    assert out["port"].engine_rows() == out["ref"].engine_rows()
    port, ref = (out[k].to_perfetto() for k in ("port", "ref"))
    assert port["traceEvents"] == ref["traceEvents"]
    pa, ra = (t["otherData"].pop("attribution") for t in (port, ref))
    assert port["otherData"] == ref["otherData"]
    assert pa.keys() == ra.keys()
    for name in pa:
        for c in CATEGORIES:
            assert abs(pa[name][c] - ra[name][c]) < 1e-6, (name, c)
    assert json.dumps(pa, sort_keys=True) != json.dumps(ra, sort_keys=True)
    assert validate_trace(out["port"].to_perfetto()) == []
