"""The port's run farm (``repro_torch/runfarm/``) held against the JAX
reference's, on the CPU, both sides in process at ``workers=0``.

Builders, fuzz campaigns and golden units carry no tensor values, so
their JSON, payload hashes, records, digests, harvests, bundles and
``deterministic_view`` must be EQUAL.  A sweep unit's digest hashes its
output bytes: its value-free parts (ok, counts, counters, failures,
harvested divergences, modeled rows) are compared with the reference's,
its outputs within the matmul tolerance 1e-4 * max(1, max|ref|), and its
digest only port to port, at 0 and 2 workers.  A serving unit serves the
reference's bf16 weights, carried across through
``builtin._serving_params``: the same counts, counters, admission
invariants and SLO digest (rows in modeled cycles plus the greedy tokens).
The behaviours of the reference's ``tests/test_runfarm.py`` are in
``tests/test_torch_runfarm.py``.
"""
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.runfarm as ref_rf
import repro_torch.core as port_core
import repro_torch.runfarm as rf
from repro_torch.convert import params_from_reference
from repro_torch.runfarm import (CampaignManager, builtin, execute_unit,
                                 fork_seed, golden_units, serving_units,
                                 sweep_units)
from torch_ranks import ranks_lock

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_NAMES = ["single_device_launch", "fabric_all_reduce",
                "fabric_batched_launch", "fabric_torus_all_reduce",
                "faulty_fuzz", "cluster_serving_storm",
                "cluster_open_loop_serving"]
BUG = (1, 2, 1.0)
BURSTY = [{"kind": "bursty",
           "params": {"n_requests": 8, "burst_size": 4,
                      "gap_between": 400.0}}]


def _det(res):
    """The determinism-gated view of a campaign result."""
    return (res.digest,
            {u: res.records[u]["digest"] for u in res.uids},
            res.coverage.counts,
            res.report["deterministic"])


def _builder_calls(mod):
    return [
        mod.fuzz_units(seed=42, n_scenarios=600, batch=150),
        mod.fuzz_units(seed=5, n_scenarios=7, batch=3,
                       layers=("bridge", "registers"), gen=2,
                       start_index=4, rates={"dma_delay": 0.5},
                       bridge_ops=[2, 4], mm_bug=BUG,
                       shrink_failures=False),
        mod.sweep_units(seed=3, configs=[{"size": 4096, "tile": 128},
                                         {"size": 1024, "tile": 128},
                                         {"size": 64, "tile": 16}],
                        configs_per_unit=1),
        mod.sweep_units(seed=11, configs=[{"size": 32}, {"size": 64},
                                          {"size": 96}],
                        backends=("oracle", "interpret", "compiled"),
                        gen=1, start_index=3, congestion_seed=9,
                        mm_bug=BUG),
        mod.golden_units(GOLDEN_NAMES, gen=0, start_index=10),
        mod.serving_units(seed=9, traces=BURSTY + [
            {"kind": "poisson", "params": {"n_requests": 6}}],
            pools=[{"kv_pages": 3, "kv_page_size": 8},
                   {"kv_pages": 6, "kv_page_size": 8, "max_slots": 3}],
            devices=(1, 2), gen=3, max_ticks=1000),
    ]


@pytest.mark.parametrize("seed,label", [(0, "g00/u00000"), (42, "mut/1"),
                                        (2 ** 40, "g07/u00012"),
                                        (5, "x")])
def test_fork_seed_equals_reference(seed, label):
    assert fork_seed(seed, label) == ref_rf.fork_seed(seed, label)
    assert rf.unit_uid(seed % 100, seed % 1000) == \
        ref_rf.unit_uid(seed % 100, seed % 1000)


def test_builders_and_mutation_equal_reference():
    """Every builder's units (uid, seed, params, parent), their JSON and
    payload hashes, and a mutation of each, are the reference's."""
    for port_units, ref_units in zip(_builder_calls(rf),
                                     _builder_calls(ref_rf)):
        assert [u.to_json() for u in port_units] == \
            [u.to_json() for u in ref_units]
        assert [u.payload_hash() for u in port_units] == \
            [u.payload_hash() for u in ref_units]
        for j, (p, r) in enumerate(zip(port_units, ref_units)):
            pm = rf.mutate_unit(p, j, rf.unit_uid(1, j))
            rm = ref_rf.mutate_unit(r, j, ref_rf.unit_uid(1, j))
            assert pm.to_json() == rm.to_json()
            assert pm.payload_hash() == rm.payload_hash()
            assert rf.WorkUnit.from_json(pm.to_json()) == pm


def _value_free(records):
    """Store records without their wall-clock ``seconds``."""
    return {u: {k: v for k, v in r.items() if k != "seconds"}
            for u, r in records.items()}


def _bundles(res):
    return {p.name: json.loads(p.read_text()) for p in res.bundles}


@pytest.mark.parametrize("layers,bug", [
    (("registers",), None), (("bridge",), None), (("bridge",), BUG),
    (("bridge", "registers"), BUG)],
    ids=["registers", "bridge", "bridge-bug", "both-bug"])
def test_fuzz_campaign_equals_reference(tmp_path, layers, bug):
    """Two generations of fuzz units, with and without the planted bug:
    the same unit digests, counts, failures, harvests (shrunk repros),
    bundles, final digest, merged coverage and ``deterministic_view`` as
    the reference's campaign."""
    # the reference's bridge layer runs Pallas in interpret mode: keep
    # its campaigns to two or three units
    n, batch = (240, 60) if layers == ("registers",) else (4, 2)

    def run(mod, name, **kw):
        units = mod.fuzz_units(seed=17, n_scenarios=n, batch=batch,
                               layers=layers, bridge_ops=[2, 4],
                               mm_bug=bug)
        return mod.CampaignManager(tmp_path / name, units, seed=17,
                                   workers=0, generations=2,
                                   children_per_parent=1, max_parents=1,
                                   **kw).run()
    port = run(rf, "port", device="cpu")
    ref = run(ref_rf, "ref")
    assert port.passed == ref.passed == (bug is None)
    assert port.uids == ref.uids and len(port.uids) == len(
        port.report["deterministic"]["unit_digests"])
    assert any(u.startswith("g01/") for u in port.uids)
    assert _value_free(port.records) == _value_free(ref.records)
    assert port.digest == ref.digest
    assert port.coverage.counts == ref.coverage.counts
    assert rf.deterministic_view(port.report) == \
        ref_rf.deterministic_view(ref.report)
    assert _bundles(port) == _bundles(ref)
    if bug is not None:
        h = port.records[port.uids[0]]["harvest"] or next(
            port.records[u]["harvest"] for u in port.uids
            if port.records[u].get("harvest"))
        assert h["shrunk_ops"] == 1


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_unit_equals_reference(name):
    """A golden unit on the port: ``ok``, the sha256 of the committed
    text as its digest, and counters (from the program's own target)
    equal to the reference's recorded-target totals."""
    unit = golden_units([name])[0]
    port = execute_unit(unit, "cpu")
    ref = ref_rf.execute_unit(ref_rf.WorkUnit.from_json(unit.to_json()))
    assert port.ok and ref.ok, port.failures
    text = (ROOT / "tests" / "golden" / f"{name}.trace").read_bytes()
    assert port.digest == ref.digest == hashlib.sha256(text).hexdigest()
    assert port.counters and port.counters == ref.counters
    assert port.record(unit.payload_hash())["counters"] == \
        ref.record(unit.payload_hash())["counters"]


@pytest.fixture
def capture_sweeps(monkeypatch):
    """Each side's ``SweepReport``s, in the order their units ran."""
    got = {"port": [], "ref": []}
    for side, mod in (("port", port_core), ("ref", ref_core)):
        orig = mod.CoVerifySession.run

        def run(self, *a, _orig=orig, _side=side, **kw):
            rep = _orig(self, *a, **kw)
            got[_side].append(rep)
            return rep
        monkeypatch.setattr(mod.CoVerifySession, "run", run)
    return got


@pytest.mark.parametrize("bug", [None, BUG], ids=["clean", "bug"])
def test_sweep_units_equal_reference(tmp_path, capture_sweeps, bug):
    """Sweep units at sizes 32 and 64: the same ``ok``, counts, counters,
    failures and harvested divergences as the reference's, the same
    modeled rows, outputs within 1e-4 * max(1, max|ref|); the digest
    (which hashes the output bytes) is the same at 0 and 2 workers."""
    units = sweep_units(seed=3, configs=[{"size": 32}, {"size": 64}],
                        configs_per_unit=1, mm_bug=bug)
    for u in units:
        p = execute_unit(u, "cpu").record(u.payload_hash())
        r = ref_rf.execute_unit(ref_rf.WorkUnit.from_json(u.to_json())
                                ).record(u.payload_hash())
        for k in ("ok", "counts", "counters", "failures", "scenarios",
                  "harvest"):
            assert p.get(k) == r.get(k), (u.uid, k)
        assert p["ok"] == (bug is None)
        if bug is not None:
            assert "op #" in next(iter(p["harvest"]["divergences"].values()))
    assert len(capture_sweeps["port"]) == len(capture_sweeps["ref"]) == 2
    for prep, rrep in zip(capture_sweeps["port"], capture_sweeps["ref"]):
        assert prep.to_rows(wall=False) == rrep.to_rows(wall=False)
        for pc, rc in zip(prep.cells, rrep.cells):
            for name, arr in rc.outputs.items():
                assert np.abs(pc.outputs[name] - arr).max() <= 1e-4 * max(
                    1.0, float(np.abs(arr).max())), (pc.cell.label, name)
    if bug is None:
        seq = CampaignManager(tmp_path / "w0", units, seed=3,
                              device="cpu").run()
        with ranks_lock():
            pool = CampaignManager(tmp_path / "w2", units, seed=3,
                                   workers=2, device="cpu").run()
        assert _det(pool) == _det(seq)


@pytest.fixture(scope="module")
def ref_serving_params():
    """The reference farm's served weights: smoke llama3.2-1b, bf16, key 0."""
    from repro.configs import get_config, smoke
    from repro.models import init_params
    cfg = smoke(get_config("llama3.2-1b"))
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("devices", [1, 2])
def test_serving_unit_equals_reference(monkeypatch, ref_serving_params,
                                       devices):
    """A bursty 8-request trace on a 3-page pool, the reference's bf16
    weights on both sides: the same counts, counters, admission
    invariants and unit digest (SLO rows in modeled cycles plus the
    greedy tokens)."""
    monkeypatch.setattr(builtin, "_serving_params",
                        lambda cfg, device: params_from_reference(
                            ref_serving_params, device))
    unit = serving_units(seed=9, traces=BURSTY,
                         pools=[{"kv_pages": 3, "kv_page_size": 8}],
                         devices=(devices,))[0]
    p = execute_unit(unit, "cpu").record(unit.payload_hash())
    r = ref_rf.execute_unit(ref_rf.WorkUnit.from_json(unit.to_json())
                            ).record(unit.payload_hash())
    assert p["ok"] and r["ok"], (p["failures"], r["failures"])
    for k in ("counts", "counters", "failures", "scenarios", "digest"):
        assert p.get(k) == r.get(k), k
    assert p["counts"]["arrivals"]["deferred"] >= 1
