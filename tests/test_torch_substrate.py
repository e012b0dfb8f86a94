"""Modeled-time substrate of the PyTorch port vs the JAX reference package.

Transactions, the congestion link, counters and the register file are host
numpy/Python in both packages and carry only times, addresses, sizes and
stalls, so the comparison is EXACT (tolerance 0): canonical lines, sha256
digests, link statistics, arbiter state including the RNG stream position,
counter streams and violation strings must be equal.  The seeded random
cases are those of tests/test_simspeed.py's differential tier, driven
through both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.bridge as ref_bridge
import repro.core.congestion as ref_cong
import repro.core.counters as ref_counters
import repro.core.registers as ref_regs
import repro.core.transactions as ref_tx
import repro_torch.core.bridge as port_bridge
import repro_torch.core.congestion as port_cong
import repro_torch.core.counters as port_counters
import repro_torch.core.registers as port_regs
import repro_torch.core.transactions as port_tx

torch.set_num_threads(1)

ENGINES = ("dma_a", "dma_b", "host", "csr")
REF = dict(tx=ref_tx, cong=ref_cong, counters=ref_counters, regs=ref_regs,
           bridge=ref_bridge)
PORT = dict(tx=port_tx, cong=port_cong, counters=port_counters,
            regs=port_regs, bridge=port_bridge)


def _random_case(rng):
    """(config kwargs, batches) — the contention-heavy case factory of the
    reference's differential tier, package-neutral."""
    n_eng = int(rng.integers(1, len(ENGINES) + 1))
    cfg = dict(
        link_bytes_per_cycle=float(rng.choice([8.0, 64.0, 128.0])),
        base_latency=float(rng.choice([0.0, 40.0, 100.0])),
        dos_prob=float(rng.choice([0.0, 0.2, 0.5])),
        dos_stall=float(rng.choice([50.0, 200.0])),
        per_engine_issue_gap=float(rng.choice([0.0, 1.0, 3.0])),
        seed=int(rng.integers(1 << 31)),
        priorities=tuple((e, int(p)) for e, p in
                         zip(ENGINES, rng.integers(0, 3, len(ENGINES))))
        if rng.random() < 0.5 else (),
    )
    batches = []
    t = 0.0
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(1, 33))
        t += float(rng.integers(0, 200))
        batches.append((
            (t + rng.integers(0, 50, n).astype(np.float64)).tolist(),
            [ENGINES[int(i)] for i in rng.integers(0, n_eng, n)],
            ["read" if b else "write" for b in rng.integers(0, 2, n)],
            [int(a) for a in rng.integers(0, 1 << 24, n)],
            [int(b) for b in rng.integers(1, 1 << 16, n)],
            ["" if b else "tile" for b in rng.integers(0, 2, n)],
        ))
    return cfg, batches


def _txs(pkg, spec):
    return [pkg["tx"].Transaction(t, e, k, a, nb, tg)
            for t, e, k, a, nb, tg in zip(*spec)]


def _batch(pkg, spec):
    times, engines, kinds, addrs, nbs, tags = spec
    rec = np.zeros(len(times), dtype=pkg["tx"].BURST_DTYPE)
    rec["time"] = times
    rec["addr"] = addrs
    rec["nbytes"] = nbs
    return pkg["tx"].BurstBatch(rec, list(engines), list(kinds), list(tags))


def _run(pkg, cfg, batches, submit):
    lm = pkg["cong"].LinkModel(pkg["cong"].CongestionConfig(**cfg))
    log = pkg["tx"].TransactionLog()
    for spec in batches:
        if submit == "scalar":
            lm._submit_scalar(_txs(pkg, spec), log)
        elif submit == "object":
            lm.submit(_txs(pkg, spec), log)
        else:
            lm.submit_batch(_batch(pkg, spec), log)
    return lm, log


def _plain(obj):
    """State with Transaction records of either package as plain tuples."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.astuple(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _assert_same(ref, port):
    """Every observable of a (LinkModel, TransactionLog) run, reference vs
    port: trace bytes, digest, attribution columns, link result, arbiter
    and log state."""
    (lm_r, log_r), (lm_p, log_p) = ref, port
    assert log_r.canonical() == log_p.canonical()
    assert log_r.digest() == log_p.digest()
    assert ([(t.dos, t.fault_delay) for t in log_r.txs]
            == [(t.dos, t.fault_delay) for t in log_p.txs])
    rr, rp = lm_r.result(), lm_p.result()
    assert rr.makespan == rp.makespan
    assert rr.per_engine_stall == rp.per_engine_stall
    assert rr.per_engine_busy == rp.per_engine_busy
    assert rr.link_utilization == rp.link_utilization
    assert rr.summary() == rp.summary()
    assert _plain(lm_r.get_state()) == _plain(lm_p.get_state())
    assert _plain(log_r.get_state()) == _plain(log_p.get_state())


SUBMITS = ("scalar", "object", "batch")


@pytest.mark.parametrize("submit", SUBMITS)
@pytest.mark.parametrize("lo", range(0, 200, 40))
def test_differential_random_cases(lo, submit):
    """The 200 seeded random cases of the reference's differential tier:
    each submission path of the port equals the same path of the reference
    in every observable."""
    for seed in range(lo, lo + 40):
        cfg, batches = _random_case(np.random.default_rng(seed))
        _assert_same(_run(REF, cfg, batches, submit),
                     _run(PORT, cfg, batches, submit))


@pytest.mark.parametrize("submit", SUBMITS)
def test_differential_single_engine_rr_pointer(submit):
    cfg = dict(dos_prob=0.0, seed=1)
    solo = ([0.0] * 7, ["dma_a"] * 7, ["read"] * 7, list(range(7)),
            [64] * 7, [""] * 7)
    contended = ([0.0] * 6, ["dma_a", "dma_b", "host"] * 2, ["read"] * 6,
                 list(range(6)), [64] * 6, [""] * 6)
    ref = _run(REF, cfg, [solo, contended], submit)
    port = _run(PORT, cfg, [solo, contended], submit)
    assert ref[0]._rr == port[0]._rr
    _assert_same(ref, port)


@pytest.mark.parametrize("submit", SUBMITS)
def test_differential_priority_contention(submit):
    cfg = dict(dos_prob=0.3, seed=9, priorities=(("dma_a", 2), ("host", 1)))
    rng = np.random.default_rng(123)
    batches = []
    for _ in range(6):
        n = 24
        batches.append((
            [0.0] * n,
            [ENGINES[int(i)] for i in rng.integers(0, 4, n)],
            ["read"] * n,
            [int(a) for a in rng.integers(0, 1 << 20, n)],
            [int(b) for b in rng.integers(1, 8192, n)],
            [""] * n,
        ))
    _assert_same(_run(REF, cfg, batches, submit),
                 _run(PORT, cfg, batches, submit))


def test_port_scalar_oracle_gates_port_batch_path():
    """Inside the port, the vectorised paths stay bit-exact against the
    port's own retained scalar arbiter."""
    for seed in range(60):
        cfg, batches = _random_case(np.random.default_rng(5000 + seed))
        scalar = _run(PORT, cfg, batches, "scalar")
        _assert_same(scalar, _run(PORT, cfg, batches, "object"))
        _assert_same(scalar, _run(PORT, cfg, batches, "batch"))


def test_offline_simulate_equal():
    cfg, batches = _random_case(np.random.default_rng(77))
    out = []
    for pkg in (REF, PORT):
        txs = [t for spec in batches for t in _txs(pkg, spec)]
        res = pkg["cong"].simulate(txs, pkg["cong"].CongestionConfig(**cfg))
        out.append((res.makespan, res.per_engine_stall, res.per_engine_busy,
                    res.link_utilization, res.summary()))
    assert out[0] == out[1]


# ------------------------------------------------------------ lazy digests

def _digest_walk(pkg):
    """Digest after every mutation channel, then across a checkpoint
    restore — the lazy-digest invalidation contract."""
    spec = _random_case(np.random.default_rng(7))[1][0]
    log = pkg["tx"].TransactionLog()
    seen = []
    log.extend(_txs(pkg, spec))
    seen.append(log.digest())
    log.log(pkg["tx"].Transaction(1.0, "x", "read", 0, 4))
    seen.append(log.digest())
    log.log_batch(_batch(pkg, spec))
    seen.append(log.digest())
    log.violation("v")
    seen.append(log.digest())
    log.fault("f")
    seen.append(log.digest())
    snap = log.get_state()
    log.log(pkg["tx"].Transaction(2.0, "y", "write", 8, 4, tag="t"))
    seen.append(log.digest())
    log.set_state(snap)
    seen.append(log.digest())
    seen.append(tuple(log.cursor()))
    seen.append(tuple(log.lines_since((3, 0, 0))))
    return seen


def test_lazy_digest_walk_equal():
    ref, port = _digest_walk(REF), _digest_walk(PORT)
    assert ref == port
    assert len(set(ref[:6])) == 6 and ref[6] == ref[4]


def test_split_bursts_and_from_runs_equal():
    for step in (0, 64, 4096):
        r = ref_tx.split_bursts(3.0, "e", "read", 0x1000, 10000, "t", step)
        p = port_tx.split_bursts(3.0, "e", "read", 0x1000, 10000, "t", step)
        assert [dataclasses.astuple(t) for t in r] == \
            [dataclasses.astuple(t) for t in p]
        rb = ref_tx.BurstBatch.from_runs(3.0, "e", "write",
                                         [(0, 100), (4096, 9000)], "t", step)
        pb = port_tx.BurstBatch.from_runs(3.0, "e", "write",
                                          [(0, 100), (4096, 9000)], "t", step)
        assert rb.canonical_lines() == pb.canonical_lines()


def test_log_queries_equal():
    cfg, batches = _random_case(np.random.default_rng(11))
    (_, lr), (_, lp) = (_run(REF, cfg, batches, "batch"),
                        _run(PORT, cfg, batches, "batch"))
    assert lr.summary() == lp.summary()
    assert lr.engines() == lp.engines()
    assert lr.total_bytes() == lp.total_bytes()
    assert lr.total_stalls() == lp.total_stalls()
    assert lr.render_heatmap() == lp.render_heatmap()
    er, br = lr.bandwidth_timeline()
    ep, bp = lp.bandwidth_timeline()
    assert np.array_equal(er, ep) and br.keys() == bp.keys()
    assert all(np.array_equal(br[k], bp[k]) for k in br)


# ---------------------------------------------------------------- counters

def _bridge_program(pkg, congestion: bool):
    cfg = (pkg["cong"].CongestionConfig(dos_prob=0.2, seed=5)
           if congestion else None)
    mem = pkg["bridge"].MemoryBridge(congestion=cfg)
    rng = np.random.default_rng(3)
    mem.alloc("x", (64, 64), np.float32)
    mem.alloc("y", (64, 64), np.float32)
    mem.host_write("x", rng.normal(size=(64, 64)).astype(np.float32))
    for _ in range(3):
        data = mem.dev_read("x", engine="dma_rd")
        mem.log_burst_list([("dma_a", "read", 64 * i, 2048)
                            for i in range(40)])
        mem.dev_write("y", data * 2, engine="dma_wr")
    return mem


@pytest.mark.parametrize("congestion", [True, False])
def test_counter_stream_equal(congestion):
    mr, mp = (_bridge_program(REF, congestion),
              _bridge_program(PORT, congestion))
    assert mr.counters.canonical() == mp.counters.canonical()
    assert mr.counters.digest() == mp.counters.digest()
    assert mr.counters.totals() == mp.counters.totals()
    assert mr.counters.stream.n_samples > 0 or not congestion
    assert mr.log.digest() == mp.log.digest()
    assert mr.time == mp.time
    assert np.array_equal(mr.host_read("y"), mp.host_read("y"))
    assert (ref_counters.merged_digest([mr.counters])
            == port_counters.merged_digest([mp.counters]))


def test_owned_counter_bank_equal():
    out = []
    for pkg in (REF, PORT):
        C = pkg["counters"]
        bank = C.CounterBank("unit", interval=10.0)
        bank.register(C.CounterSpec("events", "events"))
        bank.register(C.CounterSpec("cycles", "cycles"), lambda: 1.5)
        for now in (3.0, 12.0, 47.0, 48.0, 90.0):
            bank.inc("events", 2)
            bank.tick(now)
        snap = bank.get_state()
        bank.inc("events")
        bank.tick(200.0)
        after = (bank.canonical(), bank.digest())
        bank.set_state(snap)
        out.append((after, bank.canonical(), bank.digest(), bank.totals()))
    assert out[0] == out[1]


# --------------------------------------------------------------- registers

def _register_program(pkg):
    R = pkg["regs"]
    rf = R.RegisterFile("csr")
    busy = {"v": False}
    rf.define("CTRL", 0x0, R.RW)
    rf.define("STATUS", 0x4, R.RO, reset=1)
    rf.define("IRQ", 0x8, R.W1C, reset=0xFF)
    rf.define("GO", 0xC, R.DOORBELL,
              on_write=lambda d: rf.log.violation("doorbell while busy")
              if busy["v"] else busy.update(v=True))
    rf.fb_write_32(0x0, 0x1_2345_6789)
    rf.fb_write_32(0x4, 7)              # RO write
    rf.fb_write_32(0x8, 0x0F)           # clears low nibble
    rf.fb_write_32(0xC, 1)
    rf.fb_write_32(0xC, 1)              # doorbell while busy
    rf.fb_read_32(0x100)                # unmapped read
    rf.fb_write_32(0x104, 1)            # unmapped write
    rf.poll("STATUS", 0x2, 0x2, max_reads=3)    # times out
    vals = [rf.fb_read_32(a) for a in (0x0, 0x4, 0x8, 0xC)]
    return rf, vals


def test_register_file_violations_equal():
    (rr, vr), (rp, vp) = _register_program(REF), _register_program(PORT)
    assert vr == vp
    assert rr.log.violations == rp.log.violations
    assert len(rr.log.violations) == 5
    assert rr.log.canonical() == rp.log.canonical()
    assert rr.log.digest() == rp.log.digest()
    assert rr.get_state() == rp.get_state()


def test_register_define_errors_equal():
    msgs = []
    for pkg in (REF, PORT):
        rf = pkg["regs"].RegisterFile()
        rf.define("A", 0x0)
        got = []
        for args in (("B", 0x0), ("C", 0x2)):
            with pytest.raises(ValueError) as e:
                rf.define(*args)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
