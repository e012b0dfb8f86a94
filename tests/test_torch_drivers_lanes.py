"""The port's CI lanes (``benchmarks/*_torch.py``): the run-farm and counter
campaigns held against the reference's, and the ``--check`` gates of the
serving and simulator-speed benchmarks against the committed
``BENCH_*.json`` files, on the CPU.

A run-farm fuzz campaign carries no tensor value, so its digest must equal
the reference's.  A counter campaign runs sweep units, whose digests hash
their float outputs: its lanes' digests are held equal to each other, its
fleet counters (modeled) equal to the reference's.
"""
import contextlib
import hashlib
import io
import json
from pathlib import Path

import pytest
import torch

import benchmarks.bench_counters as ref_counters
import benchmarks.bench_counters_torch as counters
import benchmarks.bench_runfarm as ref_runfarm
import benchmarks.bench_runfarm_torch as runfarm
import benchmarks.bench_serving_torch as serving
import benchmarks.bench_simspeed_torch as simspeed
from torch_ranks import ranks_lock

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_runfarm_quick_digest_equals_reference(tmp_path):
    """The quick lanes (1 and 2 spawned workers) land on one digest, the
    reference's in-process campaign's; every worker reports its
    spawn-to-ready seconds on a row of its own."""
    with ranks_lock():
        rows = runfarm.run(device="cpu")
    want = ref_runfarm.measure(ref_runfarm.QUICK_SCENARIOS, (0,),
                               tmp_path)["digest"]
    speedup = next(r for r in rows if r.startswith("speedup,"))
    assert f"digest={want[:16]};" in speedup
    ready = [r for r in rows if "_spawn_to_ready," in r]
    assert [r.split(",")[0] for r in ready] == \
        ["workers1_spawn_to_ready", "workers2_spawn_to_ready"]
    assert ready[1].split(",")[2].count("s;") == 1


def test_counters_fleet_equals_reference(tmp_path):
    """The counter campaign at 0 and 2 workers: one digest across lanes,
    one fleet; the fleet counters, the workload's sample count and its
    counter totals equal the reference's."""
    sizes = counters.SWEEP_SIZES[:2]
    with ranks_lock():
        m = counters.fleet_campaign(sizes, tmp_path / "twin", device="cpu")
    want = ref_counters.fleet_campaign(sizes, tmp_path / "ref",
                                       worker_counts=(0,))
    assert m["digest_identical"] and m["fleet_identical"]
    assert m["units"] == want["units"]
    assert m["counters"] == want["counters"]
    ov = counters.measure_overhead(1, device="cpu")
    ref_ov = ref_counters.measure_overhead(1)
    assert ov["samples"] == ref_ov["samples"] > 0
    assert ov["totals"] == ref_ov["totals"]


@pytest.mark.parametrize("reading,held", [(13.8, False), (9.9, True)])
def test_counters_gate(reading, held):
    rows = ["case,ms,detail", "counters_off,1.0,-",
            f"counters_on,1.1,overhead={reading}%;samples=3890",
            "fleet_campaign,-,units=1;digest_identical=True;"
            "fleet_identical=True"]
    ok, verdict = counters.gate(rows)
    assert ok is held
    assert verdict == (f"gate,counters_overhead_pct,{reading},<10,"
                       f"{'held' if held else 'FAILED'}")


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("mod,bench", [(serving, "BENCH_serving.json"),
                                       (simspeed, "BENCH_simspeed.json")],
                         ids=["serving", "simspeed"])
def test_check_lane_passes_and_leaves_baseline(mod, bench):
    """``--check`` passes against the committed file and does not write
    it."""
    before = _sha(ROOT / bench)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--check", "--device", "cpu"])
    out = buf.getvalue().splitlines()
    assert rc == 0, out
    assert out[-1].endswith("check: PASS")
    assert _sha(ROOT / bench) == before


def test_simspeed_check_holds_the_committed_workload():
    doc = json.loads((ROOT / "BENCH_simspeed.json").read_text())
    m = dict(doc["workload"], speedup=40.0, vector_scn_per_s=10.0)
    assert simspeed.check(m) == []
    m["txs"] += 1
    assert simspeed.check(m) == \
        [f"workload txs: {m['txs']} != committed {m['txs'] - 1}"]
