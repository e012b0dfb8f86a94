"""Off-chip data-movement profiling walkthrough (paper Fig. 8, §IV), on the
PyTorch port (``repro_torch``).

Runs the firmware-heavy CNN through the bridge with online congestion
(input-DMA priority — the paper's design choice), then reads everything
back through the ``DataMovementProfiler``: the exhaustive stall
attribution (every modeled cycle classified, closing exactly to
``bridge.time``), the per-engine Fig. 8 series reproducing the paper's
weights-vs-input DMA stall observation, the per-layer op attribution,
and a Perfetto-loadable Chrome-trace export.

Every number below is a modeled cycle count (no wall time), so the
transcript is deterministic and the same on any device: it is the fenced
transcript of docs/profiling.md, line for line.

    PYTHONPATH=src python examples/profile_cnn_torch.py [--device cpu] \
        [--trace-out PATH]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from benchmarks.cnn_driver_torch import gops, small_cnn_specs, run_cnn
from repro_torch.core import CATEGORIES, validate_trace
from repro_torch.core.congestion import CongestionConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-out",
                    default="artifacts/torch/profile_cnn.trace.json",
                    help="where to write the Perfetto/Chrome-trace JSON "
                         "(artifacts/ is gitignored)")
    ap.add_argument("--device", default="cuda",
                    help="device the matmul backends run on (cuda or cpu)")
    args = ap.parse_args(argv)

    specs = small_cnn_specs(16)
    cong = CongestionConfig(
        link_bytes_per_cycle=64.0, dos_prob=0.02, seed=7,
        priorities=(("dma_input", 2), ("dma_output", 1),
                    ("dma_weights", 0)))
    print(f"profiling small CNN ({gops(specs):.3f} GOP) through the "
          f"bridge: oracle backend,")
    print("online congestion, input DMA prioritized (paper Fig. 8)")

    fb = run_cnn(specs, backend="oracle", congestion=cong, profile=True,
                 device=args.device)
    prof = fb.profiler("profile_cnn")
    ddr = prof.channel("ddr")

    print("\nstall attribution (ddr channel, every modeled cycle "
          "classified):")
    print("  category       cycles   share")
    for cat in CATEGORIES:
        v = ddr.breakdown.cycles[cat]
        print(f"  {cat:13s} {v:8.0f}   {100 * v / ddr.horizon:5.1f}%")
    closed = sum(ddr.breakdown.cycles.values()) == ddr.horizon == fb.mem.time
    print(f"  closure: 6 categories sum to {ddr.horizon:.0f} cycles "
          f"== bridge.time: {closed}")
    print(f"  link utilization: {ddr.utilization:.2%}")

    print("\nper-engine Fig. 8 series (weights vs input vs output DMA):")
    print("  engine          bytes   txs      busy  contention_stalls")
    eng = ddr.engines
    for e in ("dma_weights", "dma_input", "dma_output"):
        s = eng[e]
        print(f"  {e:12s} {s.bytes:8d}  {s.transactions:4d}  {s.busy:8.0f}"
              f"  {s.contention:17.0f}")
    dominate = (eng["dma_weights"].contention
                > eng["dma_input"].contention)
    print(f"  weights-DMA stalls dominate under input priority: "
          f"{dominate}")

    print("\nper-layer attribution (op marks):")
    print("  layer    bytes  stall_cycles  span_cycles")
    for _, m in prof.marks:
        txs = fb.log.txs[m.tx_lo:m.tx_hi]
        print(f"  {m.op:6s} {sum(t.nbytes for t in txs):7d}  "
              f"{sum(t.stall for t in txs):12.0f}  {m.t1 - m.t0:11.0f}")

    trace = prof.to_perfetto()
    errs = validate_trace(trace)
    path = prof.save_perfetto(args.trace_out)
    print(f"\ntrace schema valid: {not errs}")
    print(f"wrote Perfetto trace: {path.name} "
          f"({len(trace['traceEvents'])} events)")
    print("load it at https://ui.perfetto.dev (one track per DMA engine,"
          " stall + transfer slices, bandwidth counters)")


if __name__ == "__main__":
    main()
