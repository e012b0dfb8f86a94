"""Run-farm scaling benchmark on the PyTorch port (``repro_torch``):
campaign scenarios/sec at 1 vs N workers (ROADMAP item 2 — overnight-scale
campaigns, FireSim run-farm style), every unit on ``--device``.

The workload is a seeded registers-layer fuzz campaign sharded into
250-scenario units by ``fuzz_units`` and driven end-to-end through
``CampaignManager`` — shard, spawn, execute, merge coverage, persist to
the JSONL store — so the measurement includes every orchestration cost a
real campaign pays, not just raw fuzzer throughput.  Determinism is
asserted OUTSIDE the timed region: every worker count must land on the
byte-identical final campaign digest, so the scaling is free.

The ≥4x scenarios/sec floor at 8 workers is **core-gated**: a pool
cannot beat physics, so the floor is enforced only when the host exposes
at least ``MIN_CORES_FOR_FLOOR`` usable cores; either way the committed
``BENCH_runfarm.json`` records the core count and whether the floor was
enforced, so a 1-core CI runner measures honestly instead of asserting
an impossibility.  A lane's wall time includes its workers' start-up;
each worker's spawn-to-ready seconds (``CampaignManager.ready_seconds``)
are reported apart from it.

    PYTHONPATH=src python benchmarks/bench_runfarm_torch.py            # quick
    PYTHONPATH=src python benchmarks/bench_runfarm_torch.py --full --json artifacts/torch/runfarm.json
    PYTHONPATH=src python benchmarks/bench_runfarm_torch.py --ci       # CI lane
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.runfarm import (CampaignInterrupted, CampaignManager,
                                 fuzz_units)

SEED = 2026
BATCH = 250
FULL_SCENARIOS = 100_000        # the committed BENCH_runfarm.json point
QUICK_SCENARIOS = 2_000         # benchmarks/run.py quick mode
CI_SCENARIOS = 10_000           # the CI mini-campaign lane
WORKER_COUNTS = (1, 8)
SPEEDUP_FLOOR = 4.0             # 8-worker vs 1-worker scenarios/sec
MIN_CORES_FOR_FLOOR = 4         # floor enforced only with real parallelism

ART = Path(__file__).resolve().parent / "artifacts" / "torch"


def usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                      # non-Linux fallback
        return os.cpu_count() or 1


def measure(n_scenarios: int, worker_counts: Sequence[int],
            base: Path, device="cuda") -> Dict:
    """One campaign per worker count over identical units; digests must
    agree bit-for-bit across all of them (the determinism bar)."""
    units = fuzz_units(seed=SEED, n_scenarios=n_scenarios, batch=BATCH)
    lanes = []
    for w in worker_counts:
        mgr = CampaignManager(base / f"w{w}", units, seed=SEED, workers=w,
                              generations=1, device=device)
        res = mgr.run()
        t = res.report["timing"]
        lanes.append({"workers": w, "digest": res.digest,
                      "scn_per_s": round(t["scenarios_per_sec"], 1),
                      "wall_s": round(t["wall_seconds"], 2),
                      "utilization": t["pool_utilization"],
                      "ready_s": dict(sorted(mgr.ready_seconds.items()))})
        if not res.passed:
            raise RuntimeError(f"workers={w} campaign failed: "
                               f"{[res.records[u]['failures'] for u in res.uids if not res.records[u]['ok']][:2]}")
    digests = {l["digest"] for l in lanes}
    if len(digests) != 1:
        raise RuntimeError(f"determinism broken across worker counts: "
                           f"{[(l['workers'], l['digest'][:16]) for l in lanes]}")
    speedup = round(lanes[-1]["scn_per_s"] / lanes[0]["scn_per_s"], 2)
    return {"scenarios": n_scenarios, "units": len(units),
            "digest": lanes[0]["digest"], "lanes": lanes,
            "speedup": speedup}


def _ready(lane: Dict) -> str:
    return ";".join(f"w{wid}={s:.2f}s" for wid, s in lane["ready_s"].items())


def run(device="cuda") -> List[str]:
    """Quick mode for benchmarks/run_torch.py: CSV rows; a worker's
    spawn-to-ready seconds on a row of their own, apart from its lane."""
    base = Path(tempfile.mkdtemp(prefix="bench_runfarm_"))
    try:
        m = measure(QUICK_SCENARIOS, (1, 2), base, device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rows = ["lane,scenarios_per_sec,detail"]
    for l in m["lanes"]:
        rows.append(f"workers{l['workers']},{l['scn_per_s']},"
                    f"util={l['utilization']}")
    for l in m["lanes"]:
        rows.append(f"workers{l['workers']}_spawn_to_ready,-,{_ready(l)}")
    rows.append(f"speedup,{m['speedup']},digest={m['digest'][:16]};"
                f"cores={usable_cores()}")
    return rows


def ci_lane(device="cuda") -> int:
    """The CI mini-campaign: bounded scenarios on 4 workers with a forced
    worker SIGKILL, plus an interrupt + resume — both digest-gated
    against the sequential oracle.  Campaign dirs land under
    benchmarks/artifacts/runfarm_ci/ (report + harvest bundles) so CI
    uploads them per run."""
    base = ART / "runfarm_ci"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    units = fuzz_units(seed=SEED, n_scenarios=CI_SCENARIOS, batch=BATCH)
    oracle = CampaignManager(base / "oracle", units, seed=SEED,
                             workers=0, generations=1, device=device).run()
    killed = CampaignManager(base / "killed", units, seed=SEED, workers=4,
                             generations=1, device=device,
                             kill_worker_after={0: 2}).run()
    try:
        CampaignManager(base / "resumed", units, seed=SEED, workers=4,
                        generations=1, interrupt_after=6,
                        device=device).run()
    except CampaignInterrupted:
        pass
    resumed = CampaignManager(base / "resumed", units, seed=SEED,
                              workers=4, generations=1, device=device).run()
    checks = {
        "killed_pool_digest": killed.digest == oracle.digest,
        "killed_pool_respawned":
            killed.report["timing"]["workers_respawned"] >= 1,
        "resumed_digest": resumed.digest == oracle.digest,
        "resumed_skipped":
            resumed.report["timing"]["units_resumed_from_store"] >= 6,
        "coverage_merge":
            killed.coverage.counts == oracle.coverage.counts
            and resumed.coverage.counts == oracle.coverage.counts,
    }
    print(f"runfarm CI lane: {CI_SCENARIOS} scenarios, "
          f"{len(units)} units, 4 workers, cores={usable_cores()}")
    print(f"  oracle digest {oracle.digest[:16]}")
    for name, ok in checks.items():
        print(f"  {name}: {'OK' if ok else 'FAIL'}")
    ok = all(checks.values())
    print("runfarm check:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device every unit runs on (cuda or cpu)")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    if "--ci" in argv:
        return ci_lane(device)
    n = FULL_SCENARIOS if "--full" in argv else QUICK_SCENARIOS
    cores = usable_cores()
    base = Path(tempfile.mkdtemp(prefix="bench_runfarm_"))
    try:
        m = measure(n, WORKER_COUNTS, base, device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"workload: {m['scenarios']} fuzz scenarios in {m['units']} "
          f"units (seed={SEED}, batch={BATCH}), cores={cores}")
    for l in m["lanes"]:
        print(f"  workers={l['workers']}: {l['scn_per_s']:.1f} "
              f"scenarios/sec (wall {l['wall_s']:.2f}s, "
              f"utilization {l['utilization']})")
        print(f"    spawn-to-ready: {_ready(l)}")
    print(f"digest identical across worker counts: {m['digest'][:16]}")
    enforce = cores >= MIN_CORES_FOR_FLOOR
    note = (f"floor enforced (cores={cores})" if enforce else
            f"floor not enforced: only {cores} usable core(s), "
            f"parallel speedup is physically unavailable")
    print(f"speedup {WORKER_COUNTS[-1]}v{WORKER_COUNTS[0]} workers: "
          f"{m['speedup']:.2f}x (floor {SPEEDUP_FLOOR}x; {note})")
    out = next((argv[i + 1] for i, a in enumerate(argv)
                if a == "--json" and i + 1 < len(argv)), None)
    if out:
        path = Path(out)
        doc = json.loads(path.read_text()) if path.exists() else {
            "bench": "runfarm",
            "unit": "scenarios/sec: end-to-end campaign throughput "
                    "(shard -> spawn -> execute -> merge coverage -> "
                    "JSONL store) over a seeded registers-layer fuzz "
                    "campaign",
            "workload": {"seed": SEED, "batch": BATCH,
                         "worker_counts": list(WORKER_COUNTS)},
            "floors": {"speedup": SPEEDUP_FLOOR,
                       "enforced_when_cores_ge": MIN_CORES_FOR_FLOOR},
            "trajectory": [],
        }
        point = {"date": time.strftime("%Y-%m-%d"), "cores": cores,
                 "scenarios": m["scenarios"],
                 "digest": m["digest"][:16],
                 "speedup": m["speedup"], "floor_enforced": enforce,
                 "note": note}
        for l in m["lanes"]:
            point[f"workers{l['workers']}_scn_per_s"] = l["scn_per_s"]
        doc["trajectory"].append(point)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {path}")
    if "--check" in argv:
        ok = (not enforce) or m["speedup"] >= SPEEDUP_FLOOR
        print("runfarm check:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
