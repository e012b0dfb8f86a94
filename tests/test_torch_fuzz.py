"""The port's fault plan and protocol fuzzer (``repro_torch/core/fuzz.py``)
vs the JAX reference's, on the CPU.

Both packages get the same seeds.  The reference runs ``jit=False``
backend tables (Pallas in interpret mode), as its own tests run it on the
CPU; the port runs with ``device="cpu"``, where the matmul kernel's
wrapper takes its plain version.  Fault traces, audit lines, transaction
logs, digests, ``summary()`` and coverage counts carry no tensor values,
so they must be EQUAL; the backends' DDR values only pass through the
differential check, at the reference's ``tol=1e-3``.  The serving and
arrivals layers compare fp32 engines whose weights the port takes from
the reference (``convert.params_from_reference``): same greedy tokens,
same digests.
"""
import hashlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.fuzz as ref_fuzz
import repro.core.transactions as ref_tx
import repro_torch.core as port_core
import repro_torch.core.fuzz as port_fuzz
import repro_torch.core.transactions as port_tx
from repro.kernels.systolic_matmul.sweep import matmul_backends as ref_mm
from repro_torch import goldens

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
FLAGS = dict(attn_impl="chunked", q_chunk=16, kv_chunk=16,
             compute_dtype="float32")


def _ref_fuzzer(**kw):
    kw.setdefault("mm_table", ref_mm(tile=ref_fuzz.ProtocolFuzzer.TILE,
                                     jit=False))
    return ref_core.ProtocolFuzzer(**kw)


def _port_fuzzer(**kw):
    return port_core.ProtocolFuzzer(device="cpu", **kw)


def _keys(events):
    return [e.key() for e in events]


# ------------------------------------------------------------ fault plan
@pytest.mark.parametrize("seed,label", [(0, "gen/0"), (7, "scn3/oracle"),
                                        (13, "fab/dev2"), (2 ** 40, "x"),
                                        (5, "scn0/regs")])
def test_fork_seeds_equal_reference(seed, label):
    ref, port = ref_core.FaultPlan(seed), port_core.FaultPlan(seed)
    assert port.fork(label).seed == ref.fork(label).seed
    want = int.from_bytes(hashlib.sha256(
        f"{seed}/{label}".encode()).digest()[:8], "little")
    assert port.fork(label).seed == want
    # the fork depends on (seed, label) only, not on the parent's stream
    port.rng.random(100)
    a = port.fork(label, scenario=4)
    assert a.seed == want and a.scenario == 4
    assert np.array_equal(a.rng.integers(0, 1 << 30, 8),
                          ref.fork(label).rng.integers(0, 1 << 30, 8))


def _txs(mod, n):
    return [mod.Transaction(0.0, "dma_a", "read", 0x1000 + 512 * i,
                            512 + 64 * (i % 3), tag="a") for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_perturb_hooks_trace_equal_reference(seed):
    """``perturb_bursts``, ``perturb_batch``, ``flip_read`` and
    ``perturb_congestion`` under one stream: the same events, audit lines,
    perturbed bursts and flipped bytes as the reference; the batch hook
    draw for draw the scalar one."""
    rates = {k: 0.6 for k in port_fuzz.DEFAULT_RATES}
    out = []
    for core, tx_mod in ((ref_core, ref_tx), (port_core, port_tx)):
        plan = core.FaultPlan(seed, rates=rates, scenario=2)
        twin = core.FaultPlan(seed, rates=rates, scenario=2)
        log, twin_log = tx_mod.TransactionLog(), tx_mod.TransactionLog()
        rows = []
        for n in (1, 4, 7):
            txs = plan.perturb_bursts(_txs(tx_mod, n), log)
            lines = [tx_mod.TransactionLog.canonical_line(t) for t in txs]
            batch = twin.perturb_batch(tx_mod.BurstBatch.from_runs(
                0.0, "dma_a", "read",
                [(0x1000 + 512 * i, 512 + 64 * (i % 3)) for i in range(n)],
                "a", 4096), twin_log)
            assert batch.canonical_lines() == lines
            rows.append(lines)
        data = np.arange(64, dtype=np.float32)
        flips = [plan.flip_read(data, "x", log) for _ in range(6)]
        cfg = plan.perturb_congestion(core.CongestionConfig(seed=3), log)
        out.append((_keys(plan.events), list(log.faults), rows, flips,
                    data.tobytes(), repr(cfg),
                    plan.rng.bit_generator.state))
        # the batch hook consumed the stream exactly as the scalar one did
        assert [e.detail for e in twin.events] == \
            [e.detail for e in plan.events
             if e.kind not in ("bitflip_read", "congestion_perturb")]
        assert list(twin_log.faults) == [
            f for f in log.faults
            if not f.startswith(("[bitflip_read]", "[congestion_perturb]"))]
    assert out[0] == out[1]


def test_fault_plan_state_round_trip():
    plan = port_core.FaultPlan(3, rates={"bitflip_read": 1.0})
    data = np.zeros(8, np.float32)
    plan.flip_read(data, "x", None)
    snap = plan.get_state()
    a = [plan.flip_read(np.zeros(8, np.float32), "x", None)
         for _ in range(4)]
    ev = list(plan.events)
    plan.set_state(snap)
    b = [plan.flip_read(np.zeros(8, np.float32), "x", None)
         for _ in range(4)]
    assert a == b and plan.events == ev


# ------------------------------------------------------------- the fuzzer
def test_bridge_and_register_layers_equal_reference():
    """Twelve scenarios over the bridge and register layers: digest,
    ``summary()``, coverage counts, every fault trace and violation list
    equal to the reference's; a same-seed rerun repeats the digest."""
    ref = _ref_fuzzer(seed=7, layers=("bridge", "registers")).run(12)
    port = _port_fuzzer(seed=7, layers=("bridge", "registers")).run(12)
    assert port.passed and ref.passed
    assert port.digest == ref.digest
    assert port.summary() == ref.summary()
    assert port.coverage.counts == ref.coverage.counts
    for a, b in zip(ref.results, port.results):
        assert _keys(b.faults) == _keys(a.faults)
        assert b.violations == a.violations and b.n_txs == a.n_txs
    again = _port_fuzzer(seed=7, layers=("bridge", "registers")).run(12)
    assert again.digest == port.digest
    other = _port_fuzzer(seed=8, layers=("bridge", "registers")).run(12)
    assert other.digest != port.digest


@pytest.mark.parametrize("seed", [0, 11])
def test_register_storm_matches_shadow_and_reference(seed):
    ref = _ref_fuzzer(seed=seed, layers=("registers",)).run(25)
    port = _port_fuzzer(seed=seed, layers=("registers",)).run(25)
    assert port.passed
    assert port.digest == ref.digest and port.summary() == ref.summary()
    for res in port.results:
        predicted = [e for e in res.faults
                     if e.kind in ("illegal_read", "illegal_write",
                                   "ro_write", "doorbell_busy",
                                   "poll_timeout")]
        assert len(res.violations) == len(predicted)


@pytest.fixture(scope="module")
def engines():
    """The serving layer's engine geometry (``_default_engine``'s) in
    fp32 on both sides, the port's weights carried from the reference."""
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
    return (RefEngine(rcfg, rparams, flags=ref_tf.RunFlags(**FLAGS), **kw),
            ServingEngine(cfg, tparams, flags=tf.RunFlags(**FLAGS),
                          device="cpu", **kw))


@pytest.mark.parametrize("layer,seed", [("serving", 9), ("arrivals", 4)])
def test_serving_layers_equal_reference(engines, layer, seed):
    """Eight scenarios of the serving (storm submit streams: duplicate
    ids, zero / full-budget max_new, pad straddles, bad lengths) or the
    arrivals layer (hostile open-loop streams against a random KV page
    pool): digests, summaries and coverage counts equal, tokens
    included."""
    ref_eng, port_eng = engines
    ref = _ref_fuzzer(seed=seed, layers=(layer,),
                      engine_factory=lambda: ref_eng).run(8)
    port = _port_fuzzer(seed=seed, layers=(layer,),
                        engine_factory=lambda: port_eng).run(8)
    assert port.passed, port.summary()["failures"]
    assert port.digest == ref.digest
    assert port.summary() == ref.summary()
    assert port.coverage.counts == ref.coverage.counts
    rerun = _port_fuzzer(seed=seed, layers=(layer,),
                         engine_factory=lambda: port_eng).run(8)
    assert rerun.digest == port.digest


def test_acceptance_run_closes_protocol_coverage():
    """The 200-scenario bridge + register run reaches 100% of the protocol
    bins (and the stimulus bins it feeds); the report names the holes of
    the layers that did not run."""
    fz = _port_fuzzer(seed=0, layers=("bridge", "registers"))
    report = fz.run(200)
    assert report.passed, report.summary()
    cov = report.coverage
    assert cov is fz.coverage
    assert cov.percent("protocol") == 100.0, cov.holes("protocol")
    for g in ("fault_kind", "burst_size", "congestion"):
        assert cov.covered(g), cov.holes(g)
    rep = cov.report()
    assert "protocol     8/8 = 100.0%" in rep
    for hole in cov.holes("serving") + cov.holes("fabric"):
        assert hole in rep


def test_planted_bug_caught_and_shrunk_like_reference():
    ref_fz = ref_core.ProtocolFuzzer(seed=0, layers=("bridge",),
                                     mm_table=ref_fuzz.planted_bug_table())
    port_fz = _port_fuzzer(seed=0, layers=("bridge",),
                           mm_table=port_fuzz.planted_bug_table(device="cpu"))
    ref_rep, port_rep = ref_fz.run(3), port_fz.run(3)
    assert not port_rep.passed
    assert port_rep.digest == ref_rep.digest
    fail = port_rep.failures()[0]
    assert fail.index == ref_rep.failures()[0].index
    assert any("divergence" in f for f in fail.failures)
    scn = port_fz.scenario(fail.index)
    sub, res = port_fz.shrink(scn, use_replay=False)
    ref_sub, ref_res = ref_fz.shrink(ref_fz.scenario(fail.index),
                                     use_replay=False)
    assert not res.ok and len(sub.ops) == 1
    assert sub.ops == scn.ops[:1] == ref_sub.ops
    assert res.digest == ref_res.digest


def test_shrink_replay_lane_raises_naming_item_8():
    """The replay lane of ``shrink`` (``use_replay=True``, the default;
    the name dates from when it raised): checkpointed prefix replay +
    binary search gives the reference's prefix, digest, failure and
    per-session ``ops_applied`` / ``replays`` counts, and the linear
    lane's prefix."""
    kw = dict(seed=1, layers=("bridge",), bridge_ops=(10, 11))
    ref_fz = ref_core.ProtocolFuzzer(mm_table=ref_fuzz.planted_bug_table(),
                                     **kw)
    port_fz = _port_fuzzer(
        mm_table=port_fuzz.planted_bug_table(device="cpu"), **kw)
    scn = port_fz.scenario(0)
    assert len(scn.ops) == 10
    import repro.core.replay as ref_rp
    real = ref_rp.DebugSession.__init__
    made = []                  # the reference's shrink keeps no counts

    def init(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    sub, res = port_fz.shrink(scn)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rp.DebugSession, "__init__", init)
        ref_sub, ref_res = ref_fz.shrink(ref_fz.scenario(0))
    assert not res.ok and sub.ops == ref_sub.ops == scn.ops[:len(sub.ops)]
    assert res.digest == ref_res.digest
    assert res.failures[0].split(":")[0] == ref_res.failures[0].split(":")[0]
    assert list(port_fz.shrink_counts) == list(port_fz.backends)
    assert list(port_fz.shrink_counts.values()) == \
        [(s.ops_applied, s.replays) for s in made]
    lin_sub, lin_res = port_fz.shrink(scn, use_replay=False)
    assert lin_sub.ops == sub.ops and lin_res.digest == res.digest
    assert port_fz.shrink_counts == {}
    # the register layer's shrink is the linear lane in both packages
    reg = _port_fuzzer(seed=11, layers=("registers",))
    sub, res = reg.shrink(reg.scenario(0))
    assert res.ok and sub.ops == reg.scenario(0).ops


def test_fuzzer_runs_on_cuda_by_default_or_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        port_core.ProtocolFuzzer(seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        port_fuzz.planted_bug_table()
    with pytest.raises(RuntimeError, match="cuda"):
        port_fuzz._default_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        port_core.run_fuzz(0, 1)


def test_port_regenerates_faulty_fuzz_golden():
    live = goldens.trace_lines(goldens.faulty_fuzz("cpu"))
    path = GOLDEN / "faulty_fuzz.trace"
    assert live == path.read_text().splitlines()
    assert hashlib.sha256(("\n".join(live) + "\n").encode()).hexdigest() == \
        hashlib.sha256(path.read_bytes()).hexdigest()
