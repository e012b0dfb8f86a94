"""Open-loop serving SLO benchmark on the PyTorch port (``repro_torch``):
the latency trajectory under load (ROADMAP item 3 — deployment-shaped
traffic against the co-verified serving engine).

Three smoke-scale cells share one warm-jit engine (``reset()`` swaps the
pool geometry between runs):

* **poisson_light** — Poisson arrivals against a pool with headroom:
  the no-contention baseline (queueing ~ 0).
* **bursty_2x**    — an ON-OFF burst whose aggregate page demand is
  about twice the pool: admission defers, p99 TTFT absorbs the
  queueing delay, nothing drops.
* **paged_tight**  — the same burst against a 3-page pool: the
  saturation corner the seventh golden trace pins at cluster scale.

Every per-cell number is **modeled cycles** (deterministic, platform-
independent — token *values* stay out of the witness, exactly like the
golden traces), so the committed ``BENCH_serving.json`` carries the
cells verbatim and ``--check`` (the CI serving lane) is a digest gate:
live SLO rows must hash to the committed digests, and the modeled
floors (p99 TTFT budget, throughput floor, zero drops) must hold.
Wall-clock throughput (runs/sec, warm) rides the ``--json`` trajectory
only — it never gates.  The engine runs on ``--device`` with bf16 weights
from a seeded generator there; ``--check`` reads the committed
``BENCH_serving.json`` and never writes it.

    PYTHONPATH=src python benchmarks/bench_serving_torch.py
    PYTHONPATH=src python benchmarks/bench_serving_torch.py --check
    PYTHONPATH=src python benchmarks/bench_serving_torch.py --json artifacts/torch/serving.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device

BENCH_PATH = Path(__file__).resolve().parents[1] / "BENCH_serving.json"

# Modeled floors for the CI lane (cycles / tokens-per-kcycle): a
# scheduler regression that inflates tail latency or strands requests
# fails deterministically, no wall-clock noise involved.
P99_TTFT_BUDGET = 1500.0
TOK_PER_KCYC_FLOOR = 5.0

CELLS = (
    ("poisson_light",
     {"kind": "poisson", "seed": 3,
      "params": {"n_requests": 8, "mean_gap": 150.0,
                 "prompt_lens": (3, 10), "max_new": (1, 4)}},
     {"kv_pages": 4, "kv_page_size": 8}),
    ("bursty_2x",
     {"kind": "bursty", "seed": 11,
      "params": {"n_requests": 8, "burst_size": 8, "gap_in_burst": 5.0,
                 "gap_between": 400.0, "prompt_lens": (3, 10),
                 "max_new": (2, 4)}},
     {"kv_pages": 4, "kv_page_size": 8}),
    ("paged_tight",
     {"kind": "bursty", "seed": 11,
      "params": {"n_requests": 8, "burst_size": 8, "gap_in_burst": 5.0,
                 "gap_between": 400.0, "prompt_lens": (3, 10),
                 "max_new": (2, 4)}},
     {"kv_pages": 3, "kv_page_size": 8}),
)


def _engine(device="cuda"):
    import torch

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import init_params
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import ServingEngine

    dev = resolve_device(device)
    cfg = smoke(get_config("llama3.2-1b"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    return ServingEngine(cfg, params, max_slots=4, max_len=32,
                         prompt_pad=8, kv_pages=4, kv_page_size=8,
                         batching="continuous",
                         flags=RunFlags(attn_impl="chunked", q_chunk=16,
                                        kv_chunk=16), device=dev)


def _run_cell(eng, spec, pool):
    from repro_torch.serving import SLOReport, build_trace, run_open_loop
    trace = build_trace(spec["kind"], spec["seed"], **spec["params"])
    eng.reset(batching="continuous", **pool)
    run_open_loop(eng, trace)
    return trace, SLOReport.from_run(trace, eng)


def _rows_digest(slo) -> str:
    """Platform-independent witness: modeled-cycle SLO rows only (token
    values never enter — the golden-trace rule)."""
    h = hashlib.sha256()
    for row in slo.to_rows():
        h.update(row.encode())
        h.update(b"\n")
    return h.hexdigest()


def measure(eng=None, device="cuda") -> Dict[str, dict]:
    eng = eng if eng is not None else _engine(device)
    cells: Dict[str, dict] = {}
    for name, spec, pool in CELLS:
        trace, slo = _run_cell(eng, spec, pool)
        assert slo.completed == len(trace.arrivals), \
            f"{name}: dropped an admitted request"
        assert eng.kv_pool.n_free == eng.kv_pool.n_pages, \
            f"{name}: KV page leak"
        cells[name] = {
            "rows_digest": _rows_digest(slo),
            "completed": slo.completed,
            "deferrals": slo.deferrals,
            "rejected": slo.rejected,
            "p50_ttft": round(slo.p50_ttft(), 1),
            "p99_ttft": round(slo.p99_ttft(), 1),
            "p50_itl": round(slo.p50_itl(), 1),
            "p99_itl": round(slo.p99_itl(), 1),
            "tok_per_kcyc": round(slo.tokens_per_kcycle(), 3),
        }
    return cells


def run(device="cuda") -> List[str]:
    """Quick mode for benchmarks/run_torch.py: CSV rows (modeled cycles)."""
    cells = measure(device=device)
    rows = ["cell,completed,deferrals,p50_ttft,p99_ttft,tok_per_kcyc,"
            "rows_digest16"]
    for name, c in cells.items():
        rows.append(f"{name},{c['completed']},{c['deferrals']},"
                    f"{c['p50_ttft']},{c['p99_ttft']},"
                    f"{c['tok_per_kcyc']},{c['rows_digest'][:16]}")
    return rows


def check(cells: Dict[str, dict]) -> List[str]:
    """The CI gate: committed-cell digest identity + modeled floors."""
    problems: List[str] = []
    committed = (json.loads(BENCH_PATH.read_text())["cells"]
                 if BENCH_PATH.exists() else None)
    if committed is None:
        problems.append(f"{BENCH_PATH.name} missing")
        committed = {}
    for name, c in cells.items():
        want = committed.get(name)
        if want is None:
            problems.append(f"{name}: not in committed cells")
        elif want != c:
            diff = [k for k in c if want.get(k) != c[k]]
            problems.append(f"{name}: drifted from committed cell "
                            f"(fields: {diff})")
        if c["p99_ttft"] > P99_TTFT_BUDGET:
            problems.append(f"{name}: p99 TTFT {c['p99_ttft']} > "
                            f"budget {P99_TTFT_BUDGET}")
        if c["tok_per_kcyc"] < TOK_PER_KCYC_FLOOR:
            problems.append(f"{name}: {c['tok_per_kcyc']} tok/kcyc < "
                            f"floor {TOK_PER_KCYC_FLOOR}")
        if c["rejected"]:
            problems.append(f"{name}: {c['rejected']} doorbell "
                            f"rejections in a feasible workload")
    if "bursty_2x" in cells and not cells["bursty_2x"]["deferrals"]:
        problems.append("bursty_2x: stimulus never oversubscribed "
                        "the pool")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda or cpu)")
    args, _ = ap.parse_known_args(argv)
    eng = _engine(args.device)
    cells = measure(eng)
    # determinism witness: a warm rerun must reproduce every cell
    assert measure(eng) == cells, "serving cells are not rerun-stable"
    print("cell,completed,deferrals,p50_ttft,p99_ttft,p99_itl,"
          "tok_per_kcyc,rows_digest16")
    for name, c in cells.items():
        print(f"{name},{c['completed']},{c['deferrals']},{c['p50_ttft']},"
              f"{c['p99_ttft']},{c['p99_itl']},{c['tok_per_kcyc']},"
              f"{c['rows_digest'][:16]}")

    out = next((argv[i + 1] for i, a in enumerate(argv)
                if a == "--json" and i + 1 < len(argv)), None)
    if out:
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            measure(eng)
        wall = (time.perf_counter() - t0) / reps
        path = Path(out)
        doc = json.loads(path.read_text()) if path.exists() else {
            "bench": "serving",
            "unit": "modeled-cycle SLO cells (deterministic, gated) + "
                    "warm wall-clock runs/sec trajectory (not gated)",
            "floors": {"p99_ttft_cycles": P99_TTFT_BUDGET,
                       "tok_per_kcyc": TOK_PER_KCYC_FLOOR},
            "cells": {},
            "trajectory": [],
        }
        doc["cells"] = cells
        doc["trajectory"].append({
            "date": time.strftime("%Y-%m-%d"),
            "runs_per_s": round(1.0 / wall, 2),
        })
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {path}")

    if "--check" in argv:
        problems = check(cells)
        for p in problems:
            print(f"  FAIL {p}")
        print("serving check:", "FAIL" if problems else "PASS")
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
