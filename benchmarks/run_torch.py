"""Benchmark driver on the PyTorch port (``repro_torch``): one function per
paper table/figure, every backend on ``--device``.

Prints ``name,us_per_call,derived`` CSV summary lines (plus each figure's
detailed CSV) and writes each figure's CSV under benchmarks/artifacts/torch/.
The wall-clock gates (profiling and counter overhead, the window replay's
speed-up) are read from their benchmark's rows by its ``gate()``, which
adds a verdict row; ``main()`` exits 1 when one does not hold.

``roofline_tables`` renders ``benchmarks/roofline_torch.py``'s two tables
from the dry-run records that ``python -m repro_torch.launch.dryrun``
wrote (none yet: empty tables); it reads JSON and runs nothing on the
device.

    PYTHONPATH=src:. python benchmarks/run_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device

ART = Path(__file__).resolve().parent / "artifacts" / "torch"


def _run(name: str, fn, gate=None) -> tuple[list[str], bool]:
    """Run one entry; returns its rows (with the gate's verdict row last
    where it has a gate) and whether the gate held."""
    t0 = time.perf_counter()
    rows = fn()
    us = (time.perf_counter() - t0) * 1e6
    held = True
    if gate is not None:
        held, verdict = gate(rows)
        rows = rows + [verdict]
    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"{name}.csv").write_text("\n".join(rows))
    derived = rows[-1].replace(",", ";") if rows else ""
    print(f"{name},{us:.0f},{derived}")
    for r in rows:
        print(f"  {r}")
    return rows, held


def entries(device) -> list[tuple]:
    """(name, rows function, gate or None) of every figure, in
    ``benchmarks/run.py``'s order."""
    from benchmarks import (bench_access_patterns_torch,
                            bench_bandwidth_profile_torch,
                            bench_counters_torch,
                            bench_debug_iteration_torch,
                            bench_fabric_scaling_torch, bench_fuzz_torch,
                            bench_hls4ml_scaling_torch, bench_profiler_torch,
                            bench_replay_torch, bench_runfarm_torch,
                            bench_serving_torch, bench_simspeed_torch)
    return [
        ("fig5_debug_iteration",
         lambda: bench_debug_iteration_torch.run(device), None),
        ("fig5_batched_sweep",
         lambda: bench_debug_iteration_torch.run_sweep(device), None),
        ("fig7_hls4ml_scaling",
         lambda: bench_hls4ml_scaling_torch.run(device), None),
        ("fig8_bandwidth_profile",
         lambda: bench_bandwidth_profile_torch.run(device), None),
        ("fig9_access_patterns",
         lambda: bench_access_patterns_torch.run(device), None),
        ("fuzz_throughput",                                 # quick mode
         lambda: bench_fuzz_torch.run(device=device), None),
        ("fabric_scaling",                                  # quick mode
         lambda: bench_fabric_scaling_torch.run(device=device), None),
        ("replay_debug_iteration",                          # quick mode
         lambda: bench_replay_torch.run(device=device),
         bench_replay_torch.gate),
        ("profiler_overhead",                               # quick mode
         lambda: bench_profiler_torch.run(device=device),
         bench_profiler_torch.gate),
        ("counters_overhead",                               # quick mode
         lambda: bench_counters_torch.run(device=device),
         bench_counters_torch.gate),
        ("simspeed",                                        # quick mode
         lambda: bench_simspeed_torch.run(device=device), None),
        ("runfarm_scaling",                                 # quick mode
         lambda: bench_runfarm_torch.run(device), None),
        ("serving_slo",                                     # quick mode
         lambda: bench_serving_torch.run(device), None),
        ("roofline_tables", _roofline, None),
    ]


def _roofline() -> list[str]:
    from benchmarks import roofline_torch
    recs = roofline_torch.load("baseline")
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "dryrun_table.md").write_text(
        roofline_torch.render_dryrun_table(recs))
    (ART / "roofline_table.md").write_text(
        roofline_torch.render_roofline_table(recs))
    return [f"roofline,baseline_cells,{len(recs)}",
            "roofline,tables,dryrun_table.md;roofline_table.md"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device every backend runs on (cuda or cpu)")
    device = resolve_device(ap.parse_args(argv).device)
    print("name,us_per_call,derived")
    held = [_run(name, fn, gate)[1] for name, fn, gate in entries(device)]
    return 0 if all(held) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
