"""The port's run farm (``repro_torch/runfarm/``) on the CPU: the
behaviours of the reference's ``tests/test_runfarm.py``, and the campaign
walkthrough.

The first eleven tests are twins of the reference's, the same behaviours
on the port with ``device="cpu"``: same campaign seed ⇒ byte-identical
merged coverage, per-unit digest set and final digest at any worker count
(0 = the sequential in-process oracle, 1/2/8 = spawned pools), across a
SIGKILL'd worker and across an interrupt + resume from the JSONL store.
The 1/2/8 + SIGKILL + resume twin keeps the reference's ``slow`` marker.
``examples/campaign_torch.py --device cpu`` must print the fenced
transcript of docs/runfarm.md line for line: every line is a digest, a
count or a coverage figure, so this checks the whole farm byte for byte
against the reference.  The parity tests against the reference's units
are in ``tests/test_torch_runfarm_parity.py``.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

import repro.runfarm as ref_rf
import repro_torch.runfarm as rf
from repro_torch.core.fuzz import FaultPlan
from repro_torch.runfarm import (CampaignInterrupted, CampaignManager,
                                 ResultStore, builtin, execute_unit,
                                 fork_seed, fuzz_units, golden_units,
                                 serving_units, sweep_units, unit_uid)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BUG = (1, 2, 1.0)
BURSTY = [{"kind": "bursty",
           "params": {"n_requests": 8, "burst_size": 4,
                      "gap_between": 400.0}}]


def _campaign(tmp, name, workers, **kw):
    units = fuzz_units(seed=42, n_scenarios=300, batch=75,
                       layers=("registers",))
    return CampaignManager(tmp / name, units, seed=42, workers=workers,
                           generations=2, children_per_parent=2,
                           max_parents=3, device="cpu", **kw)


def _det(res):
    """The determinism-gated view of a campaign result."""
    return (res.digest,
            {u: res.records[u]["digest"] for u in res.uids},
            res.coverage.counts,
            res.report["deterministic"])


# ------------------------------------------------------------ unit model
def test_unit_seeds_fork_like_fault_plans():
    """Unit seeds use the FaultPlan.fork construction, so a unit's
    stimulus is a pure function of (campaign seed, uid) — never of
    scheduling."""
    assert fork_seed(42, "g00/u00003") == \
        FaultPlan(42).fork("g00/u00003").seed
    units = fuzz_units(seed=42, n_scenarios=100, batch=30)
    assert [u.uid for u in units] == [unit_uid(0, i) for i in range(4)]
    assert [u.params["count"] for u in units] == [30, 30, 30, 10]
    again = fuzz_units(seed=42, n_scenarios=100, batch=30)
    assert [(u.seed, u.payload_hash()) for u in units] == \
        [(u.seed, u.payload_hash()) for u in again]
    # payload hash is an input-identity: any param change must move it
    other = fuzz_units(seed=42, n_scenarios=100, batch=30,
                       rates={"dma_delay": 0.5})
    assert other[0].payload_hash() != units[0].payload_hash()


def test_store_tolerates_torn_tail_and_latest_wins(tmp_path):
    """A campaign killed mid-append leaves at most one torn JSONL line;
    load() must skip it (the unit just re-runs) and keep the latest
    record per uid."""
    store = ResultStore(tmp_path / "results.jsonl")
    store.append({"uid": "g00/u00000", "digest": "aaa", "ok": True})
    store.append({"uid": "g00/u00001", "digest": "bbb", "ok": True})
    store.append({"uid": "g00/u00000", "digest": "ccc", "ok": True})
    store.close()
    with open(tmp_path / "results.jsonl", "a") as fh:
        fh.write('{"uid": "g00/u00002", "digest": "tor')   # torn tail
    recs = ResultStore(tmp_path / "results.jsonl").load()
    assert set(recs) == {"g00/u00000", "g00/u00001"}
    assert recs["g00/u00000"]["digest"] == "ccc"            # latest wins
    d1 = ResultStore.final_digest(recs)
    d2 = ResultStore.final_digest(recs, uids=["g00/u00001"])
    assert d1 != d2 and len(d1) == 64
    # the reference's digest of the same records
    assert d1 == ref_rf.ResultStore.final_digest(recs)


def test_sequential_campaign_reproduces_and_resumes(tmp_path):
    """workers=0 is the oracle: two fresh runs agree bit-for-bit, and a
    re-run over the same store executes nothing yet reports the same
    digest, coverage, and trajectory."""
    a = _campaign(tmp_path, "a", 0).run()
    b = _campaign(tmp_path, "b", 0).run()
    assert _det(a) == _det(b)
    assert a.passed and len(a.uids) > 4     # gen 0 + mutation children
    resumed = _campaign(tmp_path, "a", 0).run()
    assert _det(resumed) == _det(a)
    assert resumed.report["timing"]["units_resumed_from_store"] == \
        len(a.uids)


def test_spec_drift_invalidates_stored_records(tmp_path):
    """Same uid but different unit payload (spec changed between runs)
    must re-run, not silently reuse the stale record."""
    units = fuzz_units(seed=1, n_scenarios=40, batch=20)
    res = CampaignManager(tmp_path / "c", units, seed=1, device="cpu").run()
    drifted = fuzz_units(seed=1, n_scenarios=40, batch=10)
    assert drifted[0].uid == units[0].uid           # same uid, new payload
    assert drifted[0].payload_hash() != units[0].payload_hash()
    res2 = CampaignManager(tmp_path / "c", drifted, seed=1,
                           device="cpu").run()
    assert res2.report["timing"]["units_resumed_from_store"] == 0
    assert res2.digest != res.digest


def test_interrupt_then_resume_reproduces_digest(tmp_path):
    """A campaign stopped cleanly after N units resumes from the store
    and lands on the oracle digest, skipping exactly the stored units."""
    oracle = _campaign(tmp_path, "oracle", 0).run()
    with pytest.raises(CampaignInterrupted):
        _campaign(tmp_path, "intr", 0, interrupt_after=2).run()
    resumed = _campaign(tmp_path, "intr", 0).run()
    assert _det(resumed) == _det(oracle)
    assert resumed.report["timing"]["units_resumed_from_store"] == 2


def test_resume_on_another_device_is_refused(tmp_path, monkeypatch):
    """The device is not part of a unit, so the campaign directory records
    it: a store written on the CPU is not resumed on the card, nor the
    reverse, and the refusal runs nothing and leaves the store as it was.
    A resume on the same device still skips every stored unit."""
    import repro_torch.runfarm.manager as manager_mod
    units = fuzz_units(seed=1, n_scenarios=40, batch=20)
    res = CampaignManager(tmp_path / "c", units, seed=1, device="cpu").run()
    assert (tmp_path / "c" / "device").read_text() == "cpu\n"
    stored = (tmp_path / "c" / "results.jsonl").read_text()
    # the card's side, without a card: only the availability check goes
    monkeypatch.setattr(manager_mod, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="'cpu'.*'cuda'"):
        CampaignManager(tmp_path / "c", units, seed=1, device="cuda")
    (tmp_path / "g").mkdir()
    (tmp_path / "g" / "device").write_text("cuda\n")
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        CampaignManager(tmp_path / "g", units, seed=1, device="cpu")
    assert not (tmp_path / "g" / "results.jsonl").exists()
    assert (tmp_path / "c" / "results.jsonl").read_text() == stored
    again = CampaignManager(tmp_path / "c", units, seed=1,
                            device="cpu").run()
    assert again.digest == res.digest
    assert again.report["timing"]["units_resumed_from_store"] == len(units)


def test_coverage_guided_scheduling_is_plateau_bounded(tmp_path):
    """Generation g+1 mutates only seeds whose results newly covered
    bins; once a generation finds nothing new the campaign stops even
    with generation budget left."""
    units = fuzz_units(seed=7, n_scenarios=200, batch=50)
    res = CampaignManager(tmp_path / "c", units, seed=7, workers=0,
                          generations=10, children_per_parent=2,
                          max_parents=2, device="cpu").run()
    traj = res.report["deterministic"]["trajectory"]
    assert len(traj) < 10                   # plateau stop, not budget stop
    assert traj[0]["new_bins"] > 0
    assert traj[-1]["new_bins"] == 0
    # lineage is recorded: every generation>0 unit names its parent
    gen1 = [u for u in res.uids if u.startswith("g01/")]
    assert gen1
    for rec in (res.records[u] for u in gen1):
        assert rec["scenarios"] == 50       # params inherited from parent


def test_failure_harvesting_shrinks_and_bundles(tmp_path):
    """A failing unit ships a worker-side harvest (the ProtocolFuzzer
    shrink replay lane) and the manager persists it as a self-contained
    bundle under <campaign>/bundles/."""
    units = fuzz_units(seed=5, n_scenarios=2, batch=2, layers=("bridge",),
                       bridge_ops=[2, 4], mm_bug=BUG)
    res = CampaignManager(tmp_path / "c", units, seed=5, device="cpu").run()
    assert not res.passed
    assert res.bundles, "planted bug produced no bundle"
    bundle = json.loads(res.bundles[0].read_text())
    h = bundle["harvest"]
    assert h["layer"] == "bridge"
    assert 1 <= h["shrunk_ops"] <= h["full_ops"]
    assert "divergence" in h["failures"][0]
    # the bundle is seed-closed: re-executing the recorded unit
    # reproduces the same failing digest
    from repro_torch.runfarm.units import WorkUnit
    redo = execute_unit(WorkUnit.from_json(bundle["unit"]), "cpu")
    assert not redo.ok
    assert redo.digest == res.records[res.uids[0]]["digest"]


def test_sweep_and_golden_units_run_in_farm(tmp_path):
    """The farm shards CoVerifySession sweep slices and golden-trace
    regeneration alongside fuzz batches; sweep digests are stable and
    golden units diff against the committed traces."""
    su = sweep_units(seed=3, configs=[{"size": 32}, {"size": 64}],
                     configs_per_unit=1)
    ra = CampaignManager(tmp_path / "s1", su, seed=3, device="cpu").run()
    rb = CampaignManager(tmp_path / "s2", su, seed=3, device="cpu").run()
    assert ra.passed and ra.digest == rb.digest
    assert ra.coverage.counts == rb.coverage.counts
    gu = golden_units(["single_device_launch", "faulty_fuzz"])
    rg = CampaignManager(tmp_path / "g", gu, device="cpu").run()
    assert rg.passed, [rg.records[u]["failures"] for u in rg.uids]


def test_serving_units_run_in_farm(tmp_path):
    """Open-loop serving units: the farm shards (trace x pool x devices)
    cells, each unit's SLO digest is a pure function of its uid,
    admission invariants hold worker-side, and a tight pool surfaces
    deferred-admission coverage."""
    su = serving_units(seed=9, traces=BURSTY,
                       pools=[{"kv_pages": 3, "kv_page_size": 8}],
                       devices=(1, 2))
    assert [u.kind for u in su] == ["serving", "serving"]
    assert su[0].payload_hash() != su[1].payload_hash()
    ra = CampaignManager(tmp_path / "v1", su, seed=9, device="cpu").run()
    rb = CampaignManager(tmp_path / "v2", su, seed=9, device="cpu").run()
    assert ra.passed, [ra.records[u]["failures"] for u in ra.uids]
    assert ra.digest == rb.digest
    assert ra.coverage.counts == rb.coverage.counts
    # the 3-page pool oversubscribes a 4-burst: admission control must
    # have deferred at least once, and the arrivals group saw the shape
    assert ra.coverage.counts["arrivals"]["bursty"] >= 2
    assert ra.coverage.counts["arrivals"]["deferred"] >= 1


# -------------------------------------------- cross-process determinism
def test_two_worker_pool_matches_sequential_oracle(tmp_path):
    """Smoke-lane cross-process gate: a 2-worker spawned pool reproduces
    the sequential oracle's digest, per-unit digests, merged coverage,
    and deterministic report slice; each worker reported ready."""
    oracle = _campaign(tmp_path, "w0", 0).run()
    mgr = _campaign(tmp_path, "w2", 2)
    pool = mgr.run()
    assert _det(pool) == _det(oracle)
    # utilization accounting saw both workers
    assert len(pool.report["timing"]["per_worker"]) == 2
    assert sorted(mgr.ready_seconds) == [0, 1]
    assert all(s > 0 for s in mgr.ready_seconds.values())


@pytest.mark.slow
def test_worker_counts_1_2_8_and_sigkill_resume_match_oracle(tmp_path):
    """Same campaign seed at 1/2/8 workers ⇒ identical merged coverage
    summary and per-unit digests; SIGKILL a worker mid-campaign and the
    respawned pool still lands on the oracle digest; a killed-then-resumed
    campaign reports identically."""
    oracle = _campaign(tmp_path, "w0", 0).run()
    for n in (1, 2, 8):
        res = _campaign(tmp_path, f"w{n}", n).run()
        assert _det(res) == _det(oracle), f"workers={n} diverged"
    # SIGKILL worker 0 before its 2nd unit: unit re-enqueued, worker
    # respawned, digest unchanged
    killed = _campaign(tmp_path, "kill", 2,
                       kill_worker_after={0: 1}).run()
    assert _det(killed) == _det(oracle)
    assert killed.report["timing"]["workers_respawned"] >= 1
    # clean interrupt of a POOL campaign, then resume on fresh workers
    with pytest.raises(CampaignInterrupted):
        _campaign(tmp_path, "intr", 2, interrupt_after=2).run()
    resumed = _campaign(tmp_path, "intr", 2).run()
    assert _det(resumed) == _det(oracle)
    assert resumed.report["timing"]["units_resumed_from_store"] >= 2


# --------------------------------------------------- entry-point contract
def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """``CampaignManager`` and ``execute_unit`` run on ``"cuda"`` unless
    told otherwise, and refuse to go on on the CPU when it is absent."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    units = fuzz_units(seed=1, n_scenarios=4, batch=4)
    with pytest.raises(RuntimeError, match="cuda"):
        CampaignManager(tmp_path / "c", units)
    with pytest.raises(RuntimeError, match="cuda"):
        execute_unit(units[0])
    with pytest.raises(KeyError, match="no executor"):
        execute_unit(rf.WorkUnit("g00/u00000", "nope", 0), "cpu")


def test_no_unit_builds_a_compiled_tier(monkeypatch):
    """Every matmul table a unit builds (golden programs, bridge fuzz with
    and without the planted bug, sweeps) is built with ``jit=False``: no
    worker calls ``torch.compile``.  On the card, building one compiled
    tier imports dynamo and inductor, seconds in every process; the
    faulty_fuzz golden paid it until its table lost the compiled tier."""
    import repro_torch.core.fuzz as fuzz_mod
    import repro_torch.goldens as goldens_mod
    import repro_torch.kernels.systolic_matmul.sweep as sweep_mod
    jits = []
    real = sweep_mod.matmul_backends

    def spy(*a, jit=True, **kw):
        jits.append(jit)
        return real(*a, jit=jit, **kw)
    for mod in (sweep_mod, fuzz_mod, goldens_mod):
        monkeypatch.setattr(mod, "matmul_backends", spy)
    units = golden_units(["single_device_launch", "faulty_fuzz",
                          "fabric_batched_launch"])
    units += fuzz_units(seed=5, n_scenarios=2, batch=2, layers=("bridge",),
                        bridge_ops=[2, 3], start_index=3)
    units += fuzz_units(seed=5, n_scenarios=2, batch=2, layers=("bridge",),
                        bridge_ops=[2, 3], mm_bug=(1, 2, 1.0), start_index=4)
    units += sweep_units(seed=3, configs=[{"size": 32}], start_index=5)
    for u in units:
        execute_unit(u, "cpu")
    assert len(jits) >= len(units) and not any(jits), jits


@pytest.mark.parametrize("exc", [SystemExit, KeyboardInterrupt,
                                 ValueError])
def test_worker_reports_any_unit_error(monkeypatch, exc):
    """A unit that raises, even ``SystemExit`` or ``KeyboardInterrupt``,
    comes back as an ``error`` message naming it, as in the reference's
    worker; the worker lives on to its clean shutdown.  Dying instead
    would read as a crash, and the manager would re-run the unit until
    its respawn budget hid the unit's own error."""
    import queue

    from repro_torch.runfarm.worker import worker_main

    def boom(unit, device):
        raise exc("unit said no")
    monkeypatch.setattr(builtin, "execute_unit", boom)
    task_q, result_q = queue.Queue(), queue.Queue()
    unit = fuzz_units(seed=1, n_scenarios=4, batch=4)[0]
    task_q.put(unit.to_json())
    task_q.put(None)
    worker_main(3, task_q, result_q, [], device="cpu")
    msgs = [result_q.get_nowait() for _ in range(result_q.qsize())]
    assert [(k, w) for k, w, _ in msgs] == [("ready", 3), ("error", 3),
                                            ("bye", 3)]
    assert msgs[1][2] == {"uid": unit.uid,
                          "error": f"{exc.__name__}: unit said no"}


def test_default_sys_path_is_src_only():
    """Spawned workers import the port from ``src/`` and nothing of
    ``tests/``: the golden programs live in ``repro_torch.goldens``."""
    assert CampaignManager._default_sys_path() == [str(ROOT / "src")]
    assert builtin.GOLDEN == ROOT / "tests" / "golden"


# ------------------------------------------------------------ walkthrough
def _fenced_transcript(doc_path: Path, sentinel: str) -> list:
    doc = doc_path.read_text().splitlines()
    i = doc.index(sentinel)
    start = doc.index("```", i) + 1
    return doc[start:doc.index("```", start)]


def test_campaign_walkthrough_prints_docs_transcript():
    """``examples/campaign_torch.py --device cpu`` prints the fenced
    transcript of docs/runfarm.md line for line (final digest
    88fda7c259f1e6e7, 6 units, 900 scenarios, the 3 -> 1 shrink)."""
    expected = _fenced_transcript(
        ROOT / "docs" / "runfarm.md",
        "prints (deterministic — digests, unit counts, and coverage "
        "only, no wall time):")
    spec = importlib.util.spec_from_file_location(
        "campaign_torch", ROOT / "examples" / "campaign_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(["--device", "cpu"]) == 0
    assert buf.getvalue().splitlines() == expected
    assert "final digest 88fda7c259f1e6e7" in expected[4]
