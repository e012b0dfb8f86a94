"""Campaign report assembly (the ``BENCH_runfarm.json`` payload).

The report is split into a ``deterministic`` section — final digest,
per-unit digest set, merged coverage, coverage trajectory — that must be
byte-identical across worker counts and kill/resume, and a ``timing``
section (scenarios/sec, per-worker utilization) that is honest wall-clock
measurement and never enters any digest or determinism gate.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional


def campaign_report(*, seed: int, workers: int, wall_seconds: float,
                    records: Dict[str, dict], uids: List[str],
                    coverage, trajectory: List[dict],
                    worker_stats: Dict[int, dict], skipped: int,
                    respawned: int, final_digest: str,
                    counter_totals: Optional[Dict[str, float]] = None
                    ) -> dict:
    recs = [records[u] for u in sorted(uids)]
    scenarios = sum(int(r.get("scenarios", 0)) for r in recs)
    busy = sum(float(w.get("busy_seconds", 0.0))
               for w in worker_stats.values())
    per_worker = {
        str(wid): {
            "units": int(w.get("units", 0)),
            "busy_seconds": round(float(w.get("busy_seconds", 0.0)), 3),
            "utilization": (round(float(w["busy_seconds"]) / wall_seconds, 4)
                            if wall_seconds > 0 else 0.0)}
        for wid, w in sorted(worker_stats.items())}
    return {
        "deterministic": {
            "seed": seed,
            "units": len(recs),
            "scenarios": scenarios,
            "final_digest": final_digest,
            "unit_digests": {r["uid"]: r["digest"] for r in recs},
            "failures": sum(1 for r in recs if not r.get("ok", True)),
            "harvested": sorted(r["uid"] for r in recs if r.get("harvest")),
            "coverage": coverage.summary() if coverage is not None else None,
            "trajectory": trajectory,
            # fleet-wide sampled-counter totals (core/counters.py):
            # merged by name in uid order, so byte-identical at any
            # worker count — part of the determinism-gated slice
            "counters": {
                n: (round(v, 6) if isinstance(v, float) else v)
                for n, v in sorted((counter_totals or {}).items())},
        },
        "timing": {
            "workers": workers,
            "wall_seconds": round(wall_seconds, 3),
            "scenarios_per_sec": (round(scenarios / wall_seconds, 1)
                                  if wall_seconds > 0 else None),
            "busy_seconds_total": round(busy, 3),
            "pool_utilization": (round(busy / (wall_seconds *
                                               max(1, workers)), 4)
                                 if wall_seconds > 0 and workers else None),
            "per_worker": per_worker,
            "units_resumed_from_store": skipped,
            "workers_respawned": respawned,
        },
    }


def write_report(path, report: dict) -> Path:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return out


def deterministic_view(report: dict) -> dict:
    """The determinism-gated slice of a report (what tests and the CI
    lane compare across worker counts / kill+resume)."""
    return report["deterministic"]
