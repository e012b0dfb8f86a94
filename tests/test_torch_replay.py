"""The port's time-travel replay and divergence bisection
(``repro_torch/core/replay.py``) vs the JAX reference's, on the CPU.

The reference runs ``jit=False`` backend tables (Pallas in interpret mode),
as its own tests run it on the CPU; the port runs with ``device="cpu"``.
Recordings are value-free (canonical transaction lines, marks, checkpoint
op indices, log digests), so for the same program they must be EQUAL on
both sides, as must every window digest, a bisection's op index, kind and
replay count, the shrinker's prefix, and the serving recordings' log
digests and greedy token streams (fp32 engines, the port's weights carried
from the reference by ``convert.params_from_reference``).  A divergence
report's text hashes DDR buffers; a buffer the backends computed in floats
is the only part that may differ (sums in other orders), so that hash is
masked where the values are floats and compared as it is where they are
exact.  No test here asserts on wall-clock time.
"""
import hashlib
import math
import re

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.fuzz as ref_fuzz
import repro.core.replay as ref_rp
import repro.kernels.systolic_matmul.ops as ref_mm_ops
import repro.kernels.systolic_matmul.sweep as ref_mm
import repro_torch.core as port_core
import repro_torch.core.fuzz as port_fuzz
import repro_torch.core.replay as rp
import repro_torch.kernels.systolic_matmul.ops as port_mm_ops
import repro_torch.kernels.systolic_matmul.sweep as port_mm
from repro_torch import goldens
from repro_torch.convert import recording_from_reference

torch.set_num_threads(1)

SIDES = {
    "port": (port_core, rp, port_mm, port_fuzz, port_mm_ops,
             dict(device="cpu")),
    "ref": (ref_core, ref_rp, ref_mm, ref_fuzz, ref_mm_ops, {}),
}
CONG = dict(dos_prob=0.05, seed=7)
FLAGS = dict(attn_impl="chunked", q_chunk=16, kv_chunk=16,
             compute_dtype="float32")


def _bridge_session(side="port", table=None, fault_seed=None, label="run",
                    interval=3):
    core, rpm, mm, _, _, kw = SIDES[side]
    table = table if table is not None else mm.matmul_backends(
        tile=16, jit=False, **kw)

    def factory():
        plan = (core.FaultPlan(seed=fault_seed) if fault_seed is not None
                else None)
        fb = core.FireBridge(congestion=core.CongestionConfig(**CONG),
                             fault_plan=plan)
        fb.register_op("mm", **table)
        return fb

    return rpm.DebugSession(factory, checkpoint_interval=interval,
                            label=label)


def _bug_table(side):
    _, _, _, fz, _, kw = SIDES[side]
    return fz.planted_bug_table(tile=16, **kw)


def _launch_program(sizes, backend="oracle", engine="mm", data=None,
                    ops=None):
    """Launches with distinct buffer names and seeded data (``data`` picks
    another generator, ``ops`` passes the burst lists of that module)."""
    def program(rec):
        for j, size in enumerate(sizes):
            rng = np.random.default_rng(size * 1009 + j)
            if data == "int":             # small integers: exact products
                a = rng.integers(-4, 5, (size, size)).astype(np.float32)
                b = rng.integers(-4, 5, (size, size)).astype(np.float32)
            else:
                a = rng.normal(size=(size, size)).astype(np.float32)
                b = rng.normal(size=(size, size)).astype(np.float32)
            rec.do("alloc", f"a{j}", a.shape, np.float32)
            rec.do("alloc", f"b{j}", b.shape, np.float32)
            rec.do("alloc", f"c{j}", (size, size), np.float32)
            rec.do("host_write", f"a{j}", a)
            rec.do("host_write", f"b{j}", b)
            bl = None if ops is None else (
                lambda s=size: ops.transactions(s, s, s, bm=16, bn=16,
                                                bk=16, dtype_bytes=4))
            rec.do("launch", "mm", backend, (f"a{j}", f"b{j}"),
                   (f"c{j}",), engine, bl, {})
    return program


def _combined(rpm, target):
    h = hashlib.sha256()
    for log in rpm.target_logs(target):
        h.update(log.digest().encode())
    return h.hexdigest()


# ------------------------------------------------- bit identity (the port)
def test_full_range_replay_matches_transaction_log_digest():
    sess = _bridge_session(fault_seed=3)
    rec = sess.record(_launch_program([32, 48, 32]))
    w = sess.replay(rec, 0, rec.n_ops)
    assert _combined(rp, w.target) == rec.log_digest
    assert w.lines == rec.window_lines(0, rec.n_ops)
    assert w.digest() == rec.window_digest(0, rec.n_ops)


def test_arbitrary_windows_replay_bit_identically():
    sess = _bridge_session(fault_seed=11, interval=4)
    rec = sess.record(_launch_program([32, 48, 64, 32, 48]))
    n = rec.n_ops
    for lo, hi in [(0, n), (1, n), (5, 17), (n - 1, n), (7, 7), (0, 1)]:
        w = sess.replay(rec, lo, hi)
        assert w.lines == rec.window_lines(lo, hi), (lo, hi)
        assert w.digest() == rec.window_digest(lo, hi)


def test_checkpoint_restore_roundtrip_matches_uninterrupted_run():
    sess = _bridge_session(fault_seed=5)
    rec = sess.record(_launch_program([48, 32, 64, 48]))
    for ck in rec.checkpoints:
        w = sess.replay(rec, ck.op_index, rec.n_ops)
        assert rp.state_fingerprint(w.target.get_state()) == \
            rec.final_fingerprint, f"checkpoint @{ck.op_index}"


def test_checkpoint_restore_keeps_lazy_digest_identity():
    sess = _bridge_session(fault_seed=7, interval=2)
    rec = sess.record(_launch_program([32, 48, 64, 32]))
    for ck in rec.checkpoints[1:]:
        prefix = sess.replay(rec, 0, ck.op_index)
        restored = sess.replay(rec, ck.op_index, ck.op_index)
        assert _combined(rp, prefix.target) == \
            _combined(rp, restored.target), ck.op_index
        resumed = sess.replay(rec, ck.op_index, rec.n_ops)
        assert _combined(rp, resumed.target) == rec.log_digest


def test_recording_bridge_proxy_records_opaque_firmware():
    fb = port_core.FireBridge(congestion=port_core.CongestionConfig(**CONG))
    fb.register_op("mm", **port_mm.matmul_backends(tile=16, jit=False,
                                                   device="cpu"))
    port_mm.matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    sess = _bridge_session()
    rec = sess.record(lambda r: port_mm.matmul_firmware(
        rp.RecordingBridge(r), "mm", "oracle", size=32, tile=16))
    assert rec.preamble + rec.lines == fb.log.canonical()
    assert rec.target.log.canonical() == fb.log.canonical()


def test_replay_counter_instrumentation():
    sess = _bridge_session()
    rec = sess.record(_launch_program([32, 32]))
    assert sess.replays == 0 and rec.replays == 0
    sess.replay(rec, 0, rec.n_ops)
    sess.replay(rec, 3, 6)
    assert sess.replays == 2 and rec.replays == 2


# ------------------------------------------------------ bisection (the port)
def _lockstep_first_divergence(sa, ra, sb, rb):
    wa = sa.replay(ra, 0, ra.n_ops)
    wb = sb.replay(rb, 0, rb.n_ops)
    for ta, tb in zip(wa.ops, wb.ops):
        if ta.lines != tb.lines or ta.func_fingerprint != tb.func_fingerprint:
            return ta.op_index
    return None


def test_bisect_planted_data_divergence_within_replay_budget():
    sizes = [32, 48, 32, 64, 48, 32, 48, 64]
    sa = _bridge_session(label="good")
    ra = sa.record(_launch_program(sizes, backend="oracle"))
    sb = _bridge_session(table=_bug_table("port"), label="bad")
    rb = sb.record(_launch_program(sizes, backend="interpret"))
    expected = _lockstep_first_divergence(
        _bridge_session(label="good"), ra,
        _bridge_session(table=_bug_table("port"), label="bad"), rb)
    assert expected == 5
    before = ra.replays + rb.replays
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    used = (ra.replays + rb.replays) - before
    assert rep is not None and rep.kind == "state"
    assert rep.op_index == expected
    assert rep.n_replays == used <= math.ceil(math.log2(ra.n_ops)) + 2
    assert "c0" in rep.detail
    assert rep.state_a["buffers"]["c0"] != rep.state_b["buffers"]["c0"]


def test_bisect_trace_divergence_names_first_divergent_line():
    sizes = [32, 48, 32, 64]
    sa = _bridge_session(label="a")
    ra = sa.record(_launch_program(sizes))

    def perturbed(rec):                 # identical until launch #2's engine
        _launch_program(sizes[:2])(rec)
        _launch_program(sizes, engine="other_dma")(_Skip(rec, 12))
    sb = _bridge_session(label="b")
    rb = sb.record(perturbed)
    assert ra.n_ops == rb.n_ops
    la, lb = ra.preamble + ra.lines, rb.preamble + rb.lines
    first = next(i for i, (x, y) in enumerate(zip(la, lb)) if x != y)
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    assert rep is not None and rep.kind == "trace"
    assert rep.line_index == first
    assert (rep.line_a, rep.line_b) == (la[first], lb[first])
    assert rep.event.startswith("launch")
    assert rep.n_replays <= math.ceil(math.log2(ra.n_ops)) + 2


class _Skip:
    """A recorder that drops its first ``n`` events (the second half of a
    program whose first half another program already drove)."""

    def __init__(self, rec, n):
        self.rec, self.n = rec, n

    def do(self, *a):
        if self.n:
            self.n -= 1
            return None
        return self.rec.do(*a)


def test_fingerprint_covers_buffers_with_structural_names():
    def prog(tail):
        def program(rec):
            rec.do("alloc", "time", (4,), np.float32)
            rec.do("host_write", "time",
                   np.asarray([1, 2, 3, tail], np.float32))
        return program

    sa = _bridge_session(label="a")
    ra = sa.record(prog(4.0))
    sb = _bridge_session(label="b")
    rb = sb.record(prog(5.0))
    assert ra.final_func_fingerprint != rb.final_func_fingerprint
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    assert rep is not None and rep.kind == "state" and rep.op_index == 1


def test_fingerprint_sees_one_element_of_a_large_bf16_tensor():
    """A serving snapshot holds its cache as tensors: one element changed
    in the middle of a 4096-element bf16 tensor changes the fingerprint
    (``repr`` would elide it; numpy has no bfloat16)."""
    k = torch.randn(4096, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    state = {"cache": {"k": k}, "time": 1.0}
    before = rp.state_fingerprint(state), rp.functional_fingerprint(state)
    k2 = k.clone()
    k2[2048] += 1.0
    assert "..." in repr(k) and repr(k) == repr(k2)
    after_state = {"cache": {"k": k2}, "time": 1.0}
    assert rp.state_fingerprint(after_state) != before[0]
    assert rp.functional_fingerprint(after_state) != before[1]
    # dtype and shape enter too; a tensor's copy hashes the same
    assert rp.state_fingerprint({"cache": {"k": k.clone()}, "time": 1.0}) \
        == before[0]
    assert rp.state_fingerprint({"cache": {"k": k.view(64, 64)},
                                 "time": 1.0}) != before[0]
    assert rp.state_fingerprint({"cache": {"k": torch.tensor(1.0)}}) != \
        rp.state_fingerprint({"cache": {"k": torch.tensor(2.0)}})


def test_bisect_identical_runs_returns_none():
    sa = _bridge_session(fault_seed=9, label="x")
    ra = sa.record(_launch_program([32, 48]))
    sb = _bridge_session(fault_seed=9, label="y")
    rb = sb.record(_launch_program([32, 48]))
    assert rp.bisect_divergence(sa, ra, sb, rb) is None


def test_bisect_timing_perturbed_runs_diverge_on_trace_not_state():
    sa = _bridge_session(fault_seed=1, label="seed1")
    ra = sa.record(_launch_program([32, 48, 32]))
    sb = _bridge_session(fault_seed=2, label="seed2")
    rb = sb.record(_launch_program([32, 48, 32]))
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    assert rep is not None and rep.kind in ("trace", "preamble")
    assert ra.final_func_fingerprint == rb.final_func_fingerprint


def test_bisect_length_divergence():
    sa = _bridge_session(label="short")
    ra = sa.record(_launch_program([32, 48]))
    sb = _bridge_session(label="long")
    rb = sb.record(_launch_program([32, 48, 32]))
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    assert rep is not None and rep.kind == "length"
    assert rep.op_index == ra.n_ops


# -------------------------------------------- the golden programs, recorded
def _golden_run(side, name):
    """The recorded golden program ``name`` on one side (the reference's
    ``tests/test_golden_traces.py`` builders)."""
    core, rpm, mm, fz, _, kw = SIDES[side]
    if name == "single_device_launch":
        def factory():
            fb = core.FireBridge(congestion=core.CongestionConfig(**CONG))
            fb.register_op("mm", **mm.matmul_backends(tile=16, jit=False,
                                                      **kw))
            return fb
        sess = rpm.DebugSession(factory, checkpoint_interval=3, label=name)
        return sess, sess.record(lambda r: mm.matmul_firmware(
            rpm.RecordingBridge(r), "mm", "oracle", size=32, tile=16))
    if name == "fabric_all_reduce":
        link = core.CongestionConfig(
            link_bytes_per_cycle=64.0, base_latency=100.0,
            max_burst_bytes=4096, dos_prob=0.05, seed=11)
        sess = rpm.DebugSession(lambda: core.FabricCluster(
            4, link_config=link), checkpoint_interval=4, label=name)

        def program(rec):
            for i in range(4):
                rec.do("dev_alloc", i, "grad", (16, 16), np.float32)
                rec.do("dev_host_write", i, "grad",
                       np.full((16, 16), float(i + 1), np.float32))
            rec.do("all_reduce", "grad", "sum")
        return sess, sess.record(program)
    f = core.ProtocolFuzzer(seed=5, layers=("bridge",), bridge_ops=(3, 4),
                            **({"mm_table": mm.matmul_backends(
                                tile=16, jit=False)} if side == "ref"
                               else kw))
    return f._record_bridge_scenario(f.scenario(0), "oracle",
                                     checkpoint_every=1)


GOLDEN_BISECT = {"single_device_launch": "host_write",
                 "fabric_all_reduce": "dev_host_write",
                 "faulty_fuzz": "host_write"}


@pytest.mark.parametrize("name", sorted(GOLDEN_BISECT))
def test_golden_recordings_equal_reference_and_goldens(name):
    """The recorded golden program regenerates the committed trace, and
    its recording — digest, ops, every window digest, checkpoint op
    indices, log digest — is the reference's."""
    _, prec = _golden_run("port", name)
    _, rrec = _golden_run("ref", name)
    assert goldens.trace_lines(prec.target) == \
        goldens.trace_lines(goldens.PROGRAMS[name]("cpu"))
    assert prec.digest() == rrec.digest() and prec.n_ops == rrec.n_ops
    assert prec.log_digest == rrec.log_digest
    assert [c.op_index for c in prec.checkpoints] == \
        [c.op_index for c in rrec.checkpoints]
    assert prec.tx_marks == rrec.tx_marks
    n = prec.n_ops
    for lo in range(n + 1):
        for hi in range(lo, n + 1):
            assert prec.window_digest(lo, hi) == rrec.window_digest(lo, hi)


@pytest.mark.parametrize("name", sorted(GOLDEN_BISECT))
def test_bisect_golden_programs_matches_full_diff(name):
    """A late single-event perturbation of a golden program is localized
    to the op a full-trace + state diff names, within ceil(log2 N) + 2
    replays, and at the reference's op and replay count."""
    kind = GOLDEN_BISECT[name]
    found = {}
    for side in ("port", "ref"):
        rpm = SIDES[side][1]
        sa, ra = _golden_run(side, name)
        k = max(i for i, ev in enumerate(ra.events) if ev.kind == kind)
        events = list(ra.events)
        args = list(events[k].args)
        i = next(i for i, a in enumerate(args) if isinstance(a, np.ndarray))
        args[i] = args[i] + np.float32(1.0)
        events[k] = rpm.TimelineEvent(events[k].kind, tuple(args))
        sb, _ = _golden_run(side, name)
        rb = sb.record(events)
        if side == "port":
            assert _lockstep_first_divergence(
                _golden_run(side, name)[0], ra,
                _golden_run(side, name)[0], rb) == k
        before = ra.replays + rb.replays
        rep = rpm.bisect_divergence(sa, ra, sb, rb)
        assert rep is not None and rep.op_index == k
        assert rep.n_replays == ra.replays + rb.replays - before <= \
            math.ceil(math.log2(max(2, ra.n_ops))) + 2
        found[side] = (rep.op_index, rep.kind, rep.n_replays, rep.window,
                       rep.line_index, rep.line_a, rep.line_b)
    assert found["port"] == found["ref"]


# ------------------------------------------------ bisection vs the reference
_BUF = re.compile(r"'(c\d*)': '[0-9a-f]{12}'")


def _mask_float_outputs(text):
    """A divergence report with the hash of each computed (float) output
    buffer masked: the backends sum in other orders, and nothing the port
    pins hashes a float output."""
    text = _BUF.sub(r"'\1': <float>", text)
    return re.sub(r"(buffers/c\d* = )'[0-9a-f]{12}' vs '[0-9a-f]{12}'",
                  r"\1<float> vs <float>", text)


def _planted(side, data=None):
    sizes = [32, 48, 32, 64, 48, 32, 48, 64]
    sa = _bridge_session(side, label="good")
    ra = sa.record(_launch_program(sizes, "oracle", data=data))
    sb = _bridge_session(side, table=_bug_table(side), label="bad")
    rb = sb.record(_launch_program(sizes, "interpret", data=data))
    return ra, SIDES[side][1].bisect_divergence(sa, ra, sb, rb)


def test_bisect_planted_bug_report_equals_reference():
    """The planted-bug program (seeded float data): the reference's op
    index, kind, window, replay count, recording digest and checkpoints,
    and its ``render()`` text once the float outputs' hashes are masked."""
    pr, prep = _planted("port")
    rr, rrep = _planted("ref")
    assert (prep.op_index, prep.kind, prep.window, prep.n_replays) == \
        (rrep.op_index, rrep.kind, rrep.window, rrep.n_replays) == \
        (5, "state", (3, 6), 2)
    assert pr.digest() == rr.digest()
    assert [c.op_index for c in pr.checkpoints] == \
        [c.op_index for c in rr.checkpoints]
    assert prep.render() != _mask_float_outputs(prep.render())
    assert _mask_float_outputs(prep.render()) == \
        _mask_float_outputs(rrep.render())
    assert prep.context_a == rrep.context_a


def test_bisect_planted_bug_report_equals_reference_byte_for_byte():
    """The same program on small-integer data, whose products are exact
    in any summation order: the ``render()`` text is the reference's byte
    for byte, buffer hashes included."""
    _, prep = _planted("port", data="int")
    _, rrep = _planted("ref", data="int")
    assert prep.render() == rrep.render()
    assert prep.op_index == 5 and prep.kind == "state"


def test_bisect_trace_report_equals_reference():
    """A trace divergence (another DMA engine from launch #2 on): the
    reference's first divergent line, op, replay count and report text."""
    sizes = [32, 48, 32, 64]
    reps = {}
    for side in ("port", "ref"):
        rpm = SIDES[side][1]
        sa = _bridge_session(side, label="a")
        ra = sa.record(_launch_program(sizes))

        def perturbed(rec):
            _launch_program(sizes[:2])(rec)
            _launch_program(sizes, engine="other_dma")(_Skip(rec, 12))
        sb = _bridge_session(side, label="b")
        rb = sb.record(perturbed)
        reps[side] = rpm.bisect_divergence(sa, ra, sb, rb)
    p, r = reps["port"], reps["ref"]
    assert (p.kind, p.op_index, p.line_index, p.line_a, p.line_b,
            p.n_replays) == (r.kind, r.op_index, r.line_index, r.line_a,
                             r.line_b, r.n_replays)
    assert _mask_float_outputs(p.render()) == _mask_float_outputs(r.render())


def test_divergence_report_save_writes_bundle(tmp_path):
    sa = _bridge_session(label="a")
    ra = sa.record(_launch_program([32, 48]))
    sb = _bridge_session(table=_bug_table("port"), label="b")
    rb = sb.record(_launch_program([32, 48], backend="interpret"))
    rep = rp.bisect_divergence(sa, ra, sb, rb)
    path = tmp_path / "bundles" / "div.txt"
    rep.save(path)
    body = path.read_text()
    assert "first divergent op" in body and "window lines (a):" in body
    assert body.startswith(rep.render())


def test_window_report_names_op_and_state():
    sess = _bridge_session(fault_seed=3)
    rec = sess.record(_launch_program([32, 48]))
    text = rp.window_report(sess, rec, 5)
    assert text.startswith("replayed window [3, 8) of 'run'")
    assert ">> op #5: launch(" in text and "device state after op:" in text


# ------------------------------------------------------ scheduler attachment
def _sweep(side, table, fault_plan=None):
    core, _, mm, _, _, _ = SIDES[side]
    sess = core.CoVerifySession(mm.matmul_firmware,
                                congestion=core.CongestionConfig(**CONG),
                                fault_plan=fault_plan)
    sess.register_op("mm", **table)
    sess.add_sweep("mm", ("oracle", "interpret"), [{"size": 32, "tile": 16}])
    return sess.run(max_workers=2 if side == "port" else 1)


def test_failing_sweep_cell_auto_attaches_divergence_report():
    report = _sweep("port", _bug_table("port"))
    ref = _sweep("ref", _bug_table("ref"))
    assert not report.passed
    (label,) = report.divergences
    d = report.divergences[label]
    assert isinstance(d, rp.DivergenceReport)
    assert d.kind == "state" and d.event.startswith("launch")
    assert d.n_replays <= 4
    text = d.render()
    assert "first divergent op" in text and "device state" in text
    assert report.summary()["divergences"] == ref.summary()["divergences"]
    assert _mask_float_outputs(text) == \
        _mask_float_outputs(ref.divergences[label].render())


def test_passing_sweep_attaches_nothing():
    report = _sweep("port", port_mm.matmul_backends(tile=16, jit=False,
                                                    device="cpu"))
    assert report.passed and report.divergences == {}


def test_fault_plan_sweep_bisect_survives_timing_divergence():
    report = _sweep("port", _bug_table("port"),
                    fault_plan=port_core.FaultPlan(seed=5))
    ref = _sweep("ref", _bug_table("ref"),
                 fault_plan=ref_core.FaultPlan(seed=5))
    assert not report.passed
    (d,) = report.divergences.values()
    assert isinstance(d, rp.DivergenceReport) and d.op_index >= 0
    assert report.summary()["divergences"] == ref.summary()["divergences"]


# ----------------------------------------------------- replay-backed shrink
def test_shrink_with_replay_matches_legacy_and_reference():
    kw = dict(seed=1, layers=("bridge",), bridge_ops=(10, 11))
    fz = port_core.ProtocolFuzzer(
        mm_table=port_fuzz.planted_bug_table(device="cpu"), device="cpu",
        **kw)
    scn = fz.scenario(0)
    assert len(scn.ops) == 10
    sub_new, res_new = fz.shrink(scn)
    sub_old, res_old = fz.shrink(scn, use_replay=False)
    assert sub_new.ops == sub_old.ops
    assert not res_new.ok and not res_old.ok
    assert res_new.failures[0].split(":")[0] == \
        res_old.failures[0].split(":")[0]
    ref = ref_core.ProtocolFuzzer(mm_table=ref_fuzz.planted_bug_table(),
                                  **kw)
    ref_sub, ref_res = ref.shrink(ref.scenario(0))
    assert sub_new.ops == ref_sub.ops and res_new.digest == ref_res.digest


def test_shrink_replay_defers_on_non_bridge_layers():
    fz = port_core.ProtocolFuzzer(seed=11, layers=("registers",),
                                  device="cpu")
    assert fz.run(5).passed
    scn = fz.scenario(0)
    sub, res = fz.shrink(scn)
    assert res.ok and sub.ops == scn.ops


def test_recording_from_reference_replays_windows():
    """A reference bridge recording (fault plan, congestion, burst lists)
    carried into the port replays every window in a port ``DebugSession``
    to the reference's lines byte for byte, and a full-range replay to its
    log digest."""
    ref_sess = _bridge_session("ref", fault_seed=3, interval=4)
    ref_rec = ref_sess.record(_launch_program([32, 48, 32],
                                              ops=ref_mm_ops))
    rec = recording_from_reference(ref_rec)
    sess = _bridge_session("port", fault_seed=3, interval=4)
    assert rec.digest() == ref_rec.digest() and rec.n_ops == ref_rec.n_ops
    assert [c.op_index for c in rec.checkpoints] == \
        [c.op_index for c in ref_rec.checkpoints]
    n = rec.n_ops
    for lo, hi in [(0, n), (2, 11), (5, 6), (8, n), (13, 17), (n, n)]:
        w = sess.replay(rec, lo, hi)
        assert w.lines == ref_rec.window_lines(lo, hi), (lo, hi)
    w = sess.replay(rec, 0, n)
    assert _combined(rp, w.target) == ref_rec.log_digest
    launch = next(ev for ev in rec.events if ev.kind == "launch")
    assert launch.args[5]() == port_mm_ops.transactions(
        32, 32, 32, bm=16, bn=16, bk=16, dtype_bytes=4)


# -------------------------------------------------------- serving recordings
@pytest.fixture(scope="module")
def engines():
    """``_default_engine``'s geometry in fp32 on both sides (storm and
    continuous batching), the port's weights carried from the
    reference."""
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


def _storm_reqs(n=5):
    rng = np.random.default_rng(0)
    return [(rid, rng.integers(1, 200, int(rng.integers(3, 12))).astype(
        np.int32), int(rng.integers(2, 6))) for rid in range(n)]


def _tokens(target):
    return {rid: list(r.out_tokens) for rid, r in target.requests.items()}


def test_storm_recording_equals_reference(engines):
    """A serving storm through the CSR doorbell, recorded: the reference's
    recording digest, log digest and tokens; a full-range replay and a
    replay from a checkpoint taken mid-decode repeat the lines, the
    tokens and the final state fingerprint (cache hashed by its bytes)."""
    recs = {}
    for side in ("port", "ref"):
        eng = engines[side]
        rpm = SIDES[side][1]

        def factory(eng=eng):
            eng.reset(batching="storm", kv_pages=None)
            return eng
        sess = rpm.DebugSession(factory, checkpoint_interval=3,
                                label="storm")
        rec = rpm.record_serving_storm(sess, _storm_reqs())
        recs[side] = (sess, rec, _tokens(rec.target), rec.log_digest)
    sess, rec, tokens, log_digest = recs["port"]
    assert rec.digest() == recs["ref"][1].digest()
    assert log_digest == recs["ref"][3]
    assert tokens == recs["ref"][2] and len(tokens) == 5
    assert [c.op_index for c in rec.checkpoints] == \
        [c.op_index for c in recs["ref"][1].checkpoints]
    final = rec.final_fingerprint
    w = sess.replay(rec, 0, rec.n_ops)
    assert w.lines == rec.window_lines(0, rec.n_ops)
    assert _combined(rp, w.target) == log_digest
    assert rp.state_fingerprint(w.target.get_state()) == final
    assert _tokens(w.target) == tokens
    mid = None
    for ck in rec.checkpoints:
        if 0 < ck.op_index < rec.n_ops:
            t = sess.replay(rec, ck.op_index, ck.op_index).target
            if t._n_active() and any(0 < len(r.out_tokens) <
                                     r.max_new_tokens
                                     for r in t.requests.values()):
                mid = ck
                break
    assert mid is not None, "no checkpoint landed mid-decode"
    w = sess.replay(rec, mid.op_index, rec.n_ops)
    assert w.lines == rec.window_lines(mid.op_index, rec.n_ops)
    assert rp.state_fingerprint(w.target.get_state()) == final
    assert _tokens(w.target) == tokens


def test_open_loop_recording_equals_reference_and_restores_mid_decode(
        engines):
    """An open-loop run under KV-page admission control, recorded through
    the shared decision loop: the reference's recording and log digests
    and tokens; restoring a mid-decode checkpoint (requests in flight,
    pages held) and replaying the rest regenerates the run exactly."""
    recs = {}
    for side in ("port", "ref"):
        core, rpm = SIDES[side][:2]
        eng = engines[side]
        mod = __import__(("repro_torch" if side == "port" else "repro")
                         + ".serving.arrivals", fromlist=["poisson_trace"])
        trace = mod.poisson_trace(9, n_requests=6, mean_gap=150.0,
                                  prompt_lens=(3, 10), max_new=(1, 4))

        def factory(eng=eng):
            eng.reset(batching="continuous", kv_pages=4, kv_page_size=8,
                      kv_leak_every=0)
            return eng
        sess = rpm.DebugSession(factory, checkpoint_interval=6,
                                label="openloop")
        rec = rpm.record_open_loop(sess, trace)
        recs[side] = (sess, rec, _tokens(rec.target), rec.log_digest,
                      len(trace.arrivals))
    sess, rec, tokens, log_digest, n = recs["port"]
    assert rec.digest() == recs["ref"][1].digest()
    assert rec.n_ops == recs["ref"][1].n_ops
    assert log_digest == recs["ref"][3] and tokens == recs["ref"][2]
    assert len(tokens) == n
    mid = None
    for ck in rec.checkpoints:
        if not 0 < ck.op_index < rec.n_ops:
            continue
        t = sess.replay(rec, ck.op_index, ck.op_index).target
        if t._n_active() and any(0 < len(r.out_tokens) < r.max_new_tokens
                                 and not r.done
                                 for r in t.requests.values()):
            mid = ck
            assert t.kv_pool.in_use > 0
            break
    assert mid is not None, "no checkpoint landed mid-decode"
    w = sess.replay(rec, mid.op_index, rec.n_ops)
    assert w.lines == rec.window_lines(mid.op_index, rec.n_ops)
    assert w.digest() == rec.window_digest(mid.op_index, rec.n_ops)
    assert rp.state_fingerprint(w.target.get_state()) == \
        rec.final_fingerprint
    assert _tokens(w.target) == tokens
    assert w.target.kv_pool.n_free == w.target.kv_pool.n_pages
