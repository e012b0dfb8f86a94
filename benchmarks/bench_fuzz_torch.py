"""Fault-injection throughput on the PyTorch port (``repro_torch``):
randomized co-verification scenarios/sec per fuzz layer (core/fuzz.py),
the backends and the serving engine on ``--device``.

The metric that matters for the "thousands of hostile scenarios" goal is
how many seeded fault scenarios the harness retires per second — bridge
scenarios pay for three backend runs + differential check, register
scenarios are pure protocol, serving scenarios drive the full engine.

Quick mode (the default, used by benchmarks/run_torch.py) sizes the
scenario counts to finish in seconds and skips the model-building serving
layer; ``--full`` measures all three layers at 10x the scenario count.

    PYTHONPATH=src:. python benchmarks/bench_fuzz_torch.py [--full] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core import ProtocolFuzzer

QUICK_N = {"bridge": 8, "registers": 60}
FULL_N = {"bridge": 80, "registers": 600, "serving": 40}


def run(quick: bool = True, device="cuda") -> list[str]:
    counts = QUICK_N if quick else FULL_N
    rows = ["case,layer,scenarios,seconds,scenarios_per_s,faults,passed"]
    for layer, n in counts.items():
        fz = ProtocolFuzzer(seed=0, layers=(layer,), device=device)
        if layer == "serving":          # build + jit outside the timing
            fz.run(1)
        t0 = time.perf_counter()
        report = fz.run(n)
        dt = time.perf_counter() - t0
        nfaults = sum(report.fault_counts().values())
        rows.append(f"fuzz,{layer},{n},{dt:.2f},{n / dt:.1f},"
                    f"{nfaults},{report.passed}")
    return rows


def run_full(device="cuda") -> list[str]:
    return run(quick=False, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("\n".join(run(quick=not args.full, device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
