"""Always-on counter overhead + the fleet counter report, on the PyTorch
port (``repro_torch``): the workload's oracle and every campaign unit run
on ``--device``.

AutoCounter-style instrumentation is only allowed to be *always on* if
it is effectively free, so the first gate mirrors
``benchmarks/bench_profiler.py``: the 200-launch fault-injected fuzz
workload with the counter layer live vs scoped off via
``sampling_disabled()``, interleaved A/B, best-of-reps, overhead
gated < 10%: ``run()`` returns the rows with the reading in them and
``gate()`` holds it to the ceiling.

The second half is the fleet view: a bounded run-farm sweep campaign
with counters enabled on every unit, run sequentially (the oracle) and
on a 2-worker pool — the campaign digest AND the uid-merged fleet
counter totals must be byte-identical across worker counts, and the
fleet counter report is written to
``benchmarks/artifacts/torch/counters_ci/fleet_counters.json``.

    PYTHONPATH=src:. python benchmarks/bench_counters_torch.py           # quick
    PYTHONPATH=src:. python benchmarks/bench_counters_torch.py --full --json artifacts/torch/counters.json
    PYTHONPATH=src:. python benchmarks/bench_counters_torch.py --ci      # CI lane
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core.counters import (counter_banks, merged_totals,
                                       sampling_disabled)
from repro_torch.runfarm import CampaignManager, sweep_units

SEED = 2026
MAX_OVERHEAD = 0.10             # the acceptance ceiling, same as profiling
SWEEP_SIZES = (16, 32, 64)      # the CI fleet campaign's matmul configs
ART = Path(__file__).resolve().parent / "artifacts" / "torch"


def measure_overhead(repeats: int, device="cuda") -> Dict:
    """Best-of-reps wall ms of the 200-launch fuzz workload with the
    always-on counter layer live vs scoped off — the lanes interleave so
    scheduler noise hits both equally."""
    from benchmarks.bench_profiler_torch import _fuzzer, _run_workload
    fz = _fuzzer(device)
    scn = fz.scenario(0)
    _run_workload(fz, scn, profile=False)       # warm the jitted backends
    off_ts, on_ts = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        with sampling_disabled():
            _run_workload(fz, scn, profile=False)
        off_ts.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fb = _run_workload(fz, scn, profile=False)
        on_ts.append((time.perf_counter() - t0) * 1e3)
    off_ms, on_ms = min(off_ts), min(on_ts)
    samples = fb.mem.counters.stream.n_samples
    assert samples > 0, "counter lane produced no samples"
    return {"off_ms": off_ms, "on_ms": on_ms,
            "overhead": (on_ms - off_ms) / off_ms, "samples": samples,
            "totals": merged_totals(counter_banks(fb))}


def fleet_campaign(sizes, base: Path, worker_counts=(0, 2),
                   device="cuda") -> Dict:
    """One counters-on sweep campaign per worker count over identical
    units: campaign digests AND uid-merged fleet counter totals must be
    byte-identical (worker count is an execution detail, never a
    measurement detail)."""
    units = sweep_units(seed=SEED, configs=[{"size": s} for s in sizes])
    lanes = []
    for w in worker_counts:
        res = CampaignManager(base / f"w{w}", units, seed=SEED, workers=w,
                              generations=1, device=device).run()
        if not res.passed:
            raise RuntimeError(f"workers={w} counters campaign failed")
        lanes.append({"workers": w, "digest": res.digest,
                      "counters": dict(res.counters)})
    digests = {l["digest"] for l in lanes}
    fleets = [l["counters"] for l in lanes]
    return {"units": len(units), "lanes": lanes,
            "digest_identical": len(digests) == 1,
            "fleet_identical": all(f == fleets[0] for f in fleets),
            "counters": fleets[0]}


def _write_fleet_report(m: Dict) -> Path:
    out = ART / "counters_ci"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "fleet_counters.json"
    path.write_text(json.dumps(
        {"bench": "counters", "units": m["units"],
         "campaign_digest": m["lanes"][0]["digest"],
         "worker_counts": [l["workers"] for l in m["lanes"]],
         "digest_identical": m["digest_identical"],
         "fleet_identical": m["fleet_identical"],
         "counters": {n: round(float(v), 6)
                      for n, v in sorted(m["counters"].items())}},
        indent=2) + "\n")
    return path


def run(quick: bool = True, device="cuda") -> List[str]:
    """Quick mode for benchmarks/run_torch.py: CSV rows."""
    ov = measure_overhead(5 if quick else 9, device)
    base = Path(tempfile.mkdtemp(prefix="bench_counters_"))
    try:
        m = fleet_campaign(SWEEP_SIZES[:2], base, device=device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rows = ["case,ms,detail"]
    rows.append(f"counters_off,{ov['off_ms']:.1f},-")
    rows.append(f"counters_on,{ov['on_ms']:.1f},"
                f"overhead={100 * ov['overhead']:.1f}%;"
                f"samples={ov['samples']}")
    rows.append(f"fleet_campaign,-,units={m['units']};"
                f"digest_identical={m['digest_identical']};"
                f"fleet_identical={m['fleet_identical']}")
    assert m["digest_identical"] and m["fleet_identical"]
    return rows


def gate(rows: List[str]) -> tuple:
    """(held, verdict row) of the always-on counter overhead against
    ``MAX_OVERHEAD``, read from ``run()``'s rows."""
    detail = next(r for r in rows if r.startswith("counters_on,"))
    pct = float(detail.split("overhead=")[1].split("%")[0])
    held = pct < 100 * MAX_OVERHEAD
    return held, (f"gate,counters_overhead_pct,{pct},"
                  f"<{100 * MAX_OVERHEAD:.0f},{'held' if held else 'FAILED'}")


def ci_lane(device="cuda") -> int:
    """The CI counters lane: the overhead gate on the 200-launch
    workload plus the worker-count-invariant fleet campaign; the fleet
    counter report lands under benchmarks/artifacts/counters_ci/ so CI
    uploads it per run."""
    ov = measure_overhead(5, device)
    base = ART / "counters_ci"
    shutil.rmtree(base, ignore_errors=True)
    m = fleet_campaign(SWEEP_SIZES, base / "campaign", device=device)
    path = _write_fleet_report(m)
    checks = {
        "overhead_under_ceiling": ov["overhead"] < MAX_OVERHEAD,
        "stream_sampled": ov["samples"] > 0,
        "campaign_digest_identical": m["digest_identical"],
        "fleet_counters_identical": m["fleet_identical"],
        "fleet_counters_nonempty": bool(m["counters"]),
    }
    print(f"counters CI lane: 200-launch workload, "
          f"off {ov['off_ms']:.1f} ms, on {ov['on_ms']:.1f} ms, "
          f"overhead {100 * ov['overhead']:.1f}% "
          f"(ceiling {100 * MAX_OVERHEAD:.0f}%)")
    print(f"  fleet campaign: {m['units']} sweep units x workers "
          f"{[l['workers'] for l in m['lanes']]}, "
          f"{len(m['counters'])} fleet counters -> {path}")
    for name, ok in checks.items():
        print(f"  {name}: {'OK' if ok else 'FAIL'}")
    ok = all(checks.values())
    print("counters check:", "PASS" if ok else "FAIL")
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
    ov = measure_overhead(9 if "--full" in argv else 5, device)
    base = Path(tempfile.mkdtemp(prefix="bench_counters_"))
    try:
        m = fleet_campaign(SWEEP_SIZES, base, device=device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(f"workload: 200-launch fault-injected fuzz scenario, "
          f"always-on counters ({ov['samples']} samples) vs "
          f"sampling_disabled()")
    print(f"  counters_off: {ov['off_ms']:.1f} ms (best of reps)")
    print(f"  counters_on:  {ov['on_ms']:.1f} ms "
          f"-> overhead {100 * ov['overhead']:.2f}% "
          f"(ceiling {100 * MAX_OVERHEAD:.0f}%)")
    print(f"fleet campaign: {m['units']} sweep units, digest identical "
          f"across workers {[l['workers'] for l in m['lanes']]}: "
          f"{m['digest_identical']}, fleet counters identical: "
          f"{m['fleet_identical']}")
    out = next((argv[i + 1] for i, a in enumerate(argv)
                if a == "--json" and i + 1 < len(argv)), None)
    if out:
        path = Path(out)
        doc = json.loads(path.read_text()) if path.exists() else {
            "bench": "counters",
            "unit": "wall-ms overhead of the always-on counter layer on "
                    "the 200-launch fuzz workload (vs "
                    "sampling_disabled()), plus the worker-count-"
                    "invariant fleet counter campaign",
            "workload": {"seed": SEED, "launches": 200,
                         "sweep_sizes": list(SWEEP_SIZES)},
            "floors": {"max_overhead": MAX_OVERHEAD},
            "trajectory": [],
        }
        doc["trajectory"].append({
            "date": time.strftime("%Y-%m-%d"),
            "off_ms": round(ov["off_ms"], 1),
            "on_ms": round(ov["on_ms"], 1),
            "overhead_pct": round(100 * ov["overhead"], 2),
            "samples": ov["samples"],
            "fleet_units": m["units"],
            "campaign_digest": m["lanes"][0]["digest"][:16],
            "fleet_identical": m["fleet_identical"],
        })
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {path}")
    if "--check" in argv:
        ok = (ov["overhead"] < MAX_OVERHEAD and m["digest_identical"]
              and m["fleet_identical"])
        print("counters check:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
