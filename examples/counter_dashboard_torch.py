"""Always-on counter instrumentation walkthrough (AutoCounter/TracerV
analog, paper §IV), on the PyTorch port (``repro_torch``).

Runs the same fixed-seed matmul firmware through all three backends and
reads back the always-on performance-counter layer (`core/counters.py`):
the sampled counter stream of the DDR bank, the bit-exact closure of the
stall counters against the data-movement profiler's attribution, the
backend-invariant stream digest the counter-diff oracle compares — and
then plants a timing-only bug (one rogue DMA read that changes no
output) to show the oracle flagging and localizing it in far fewer
comparisons than a full trace diff.

Every number below is a modeled cycle count or a digest of modeled
state (no wall time), so the transcript is deterministic and the same on
any device: it is the fenced transcript of docs/instrumentation.md, line
for line.

    PYTHONPATH=src python examples/counter_dashboard_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import CongestionConfig, FireBridge
from repro_torch.core.counters import counter_banks, diff_streams, merged_digest
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                 matmul_firmware)

CONG = CongestionConfig(dos_prob=0.05, seed=7)
BACKENDS = ("oracle", "interpret", "compiled")


def _mm_run(backend, device="cuda"):
    fb = FireBridge(congestion=CONG)
    fb.register_op("mm", **matmul_backends(tile=16, device=device,
                                           jit=False))
    matmul_firmware(fb, "mm", backend, size=32, tile=16)
    return fb


def _dma_run(rogue):
    """Fixed DMA workload; ``rogue`` plants one extra early read — a
    timing-only perturbation that changes no functional state."""
    fb = FireBridge(congestion=CONG)
    a = np.random.default_rng(7).normal(size=(32, 32)).astype(np.float32)
    fb.mem.alloc("a", a.shape, np.float32)
    fb.mem.host_write("a", a)
    if rogue:
        fb.mem.dev_read("a", engine="dma_rogue")
    for _ in range(12):
        fb.mem.dev_read("a", engine="dma")
        fb.mem.dev_write("a", a, engine="dma")
    return fb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the matmul backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("always-on counters: fixed-seed DMA + matmul firmware, online "
          "congestion")

    good = _dma_run(rogue=False)
    bank = good.mem.counters

    print(f"\nsampled counter stream: bank {bank.name} "
          f"(interval={bank.interval:.0f} modeled cycles, sample-and-hold)")
    names = [s.name for s in bank.specs]
    cols = ("transactions", "bytes_moved", "busy_cycles", "stall_cycles",
            "cycles")
    idx = [names.index(c) for c in cols]
    print("  t        " + "".join(f"{c:>13s}" for c in cols))
    for t, row in zip(bank.stream.times, bank.stream.rows):
        print(f"  {t:7.0f}  " + "".join(f"{row[j]:13.0f}" for j in idx))

    prof = good.profiler("dashboard")
    ddr = prof.channel("ddr")
    stall = 0.0
    for name in sorted(ddr.engines):
        stall += ddr.engines[name].grant_stall
    print("\nclosure against the profiler (bit-exact, no tolerance):")
    print(f"  bank stall_cycles == profiler grant-stall fold: "
          f"{bank.value('stall_cycles') == stall}")
    total = 0.0
    for c in ("transfer", "contention", "serialization", "dos",
              "fault_delay", "compute"):
        total += ddr.breakdown.cycles[c]
    print(f"  6 stall categories sum to bank cycles "
          f"({bank.value('cycles'):.0f}): {total == bank.value('cycles')}")

    print("\ncounter-stream digests across backends (the oracle's cheap "
          "witness, same-seed matmul):")
    digests = {be: merged_digest(counter_banks(_mm_run(be, device)))
               for be in BACKENDS}
    for be in BACKENDS:
        print(f"  {be:10s} {digests[be][:16]}")
    print(f"  backend-invariant: {len(set(digests.values())) == 1}")

    print("\nplanted timing-only bug (one rogue DMA read, outputs "
          "unchanged):")
    bad = _dma_run(rogue=True)
    diff, comparisons = diff_streams(counter_banks(good),
                                     counter_banks(bad))
    for line in diff.render().splitlines():
        print(f"  {line}")
    trace_lines = len(good.log.canonical()) + len(bad.log.canonical())
    print(f"  localized in {comparisons} scalar comparisons vs "
          f"{trace_lines} trace lines to diff")


if __name__ == "__main__":
    main()
