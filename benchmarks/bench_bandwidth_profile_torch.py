"""Fig. 8 reproduction: memory-bandwidth utilization + stalls of the three
DMA engines of a CGRA-style accelerator over a ResNet-18 inference
(~0.7 GOP), with input-DMA priority (the paper's design choice) — the
weights DMA should therefore accumulate the most interconnect stalls,
validating the early-modeling tradeoff exactly as the paper observes.

The congestion link runs *online* (§IV-C) and the numbers are read back
through the off-chip data-movement profiler (core/profiler.py): the
bridge runs with ``profile=True`` and every row below — per-engine bytes,
transactions, stalls, busy cycles, link utilization, makespan, and the
bandwidth-timeline sparklines — comes from one ``DataMovementProfiler``
over the finished run (byte-identical to the pre-profiler readout, which
mixed ``log.summary()`` and ``congestion_stats()``).  On the PyTorch port
(``repro_torch``): the oracle matmul runs on ``device``; every row is
modeled, so the rows are the same on any device.

    PYTHONPATH=src:. python benchmarks/bench_bandwidth_profile_torch.py \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from benchmarks.cnn_driver_torch import gops, resnet18_specs, run_cnn
from repro_torch._device import resolve_device
from repro_torch.core.congestion import CongestionConfig


def run(device="cuda") -> list[str]:
    specs = resnet18_specs(hw=36)            # ~0.7 GOP like the paper
    cfg = CongestionConfig(
        link_bytes_per_cycle=64.0, base_latency=40.0, dos_prob=0.02,
        seed=7, priorities=(("dma_input", 2), ("dma_output", 1),
                            ("dma_weights", 0)))
    fb = run_cnn(specs, backend="oracle", congestion=cfg, profile=True,
                 device=device)
    prof = fb.profiler()
    ddr = prof.channel("ddr")

    rows = [f"# ResNet-18 {gops(specs):.2f} GOP through the bridge; "
            f"input DMA prioritized (paper's design choice); online link",
            "case,engine,bytes,transactions,stall_cycles,busy_cycles"]
    for e in ("dma_weights", "dma_input", "dma_output"):
        s = ddr.engines[e]
        rows.append(
            f"fig8,{e},{s.bytes},{s.transactions},"
            f"{s.stall:.0f},{s.busy:.0f}")
    rows.append(f"fig8,link_utilization,,,{ddr.utilization:.3f},")
    rows.append(f"fig8,makespan_cycles,,,{ddr.horizon:.0f},")

    # bandwidth-utilization timeline (bucketed), per engine
    edges, tl = prof.bandwidth_timeline(n_buckets=24)
    for e, series in sorted(tl.items()):
        if not e.startswith("dma_"):
            continue
        spark = "".join(" .:-=+*#%@"[min(int(v / (series.max() or 1) * 9), 9)]
                        for v in series)
        rows.append(f"fig8_timeline,{e},[{spark}]")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    device = resolve_device(ap.parse_args(argv).device)
    print("\n".join(run(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
