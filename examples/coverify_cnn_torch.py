"""Paper §V-D end-to-end: co-verify a firmware-heavy CNN accelerator, on
the PyTorch port (``repro_torch``).

The firmware does the paper's firmware jobs — im2col tiling/retiling,
ping-pong buffering, weight prefetch — and launches the systolic-array
matmul kernel through the memory bridge.  The SAME firmware runs against
the torch oracle ("early model") and the hand-written systolic-matmul
kernel ("RTL sim", its plain version on the CPU), both on ``--device``;
final DDR state is diffed and the transaction stream is profiled (Fig. 8/9).

Congestion is emulated *online* (§IV-C): the interpret-mode bridge carries
a CongestionConfig with input-DMA priority, so the three DMA engines
contend on the shared link while the layers execute and the stall
statistics below come straight from the run — no post-hoc replay step.
This reproduces the paper's weights-DMA-stall observation (Fig. 8).

    PYTHONPATH=src python examples/coverify_cnn_torch.py [--model resnet18] \
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from benchmarks.cnn_driver_torch import (gops, resnet18_specs, run_cnn,
                                         small_cnn_specs)
from repro_torch._device import resolve_device
from repro_torch.core.congestion import CongestionConfig

CONG = CongestionConfig(
    link_bytes_per_cycle=64.0, dos_prob=0.02, seed=7,
    priorities=(("dma_input", 2), ("dma_output", 1), ("dma_weights", 0)))


def congestion_report(fb) -> list:
    """The modeled part of the transcript: per-engine stalls and busy
    cycles, link utilization, makespan and the input-read heatmap of the
    interpret run's bridge (nothing here depends on a computed value)."""
    res = fb.congestion_stats()
    lines = ["", "online congestion (input DMA prioritized, paper Fig. 8):"]
    for e in ("dma_weights", "dma_input", "dma_output"):
        stall = res.per_engine_stall.get(e, 0)
        busy = res.per_engine_busy.get(e, 0)
        lines.append(f"  {e:12s} stalls={stall:10.0f} busy={busy:10.0f} "
                     f"cycles")
    lines.append(f"  link utilization: {res.link_utilization:.2%}")
    lines.append(f"  makespan: {res.makespan:.0f} cycles "
                 f"(= bridge time {fb.mem.time:.0f})")
    lines += ["", "input-read access heatmap (address x time, Fig. 9):",
              fb.log.render_heatmap(12, 64, kind="read")]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["small", "resnet18"],
                    default="small")
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    specs = small_cnn_specs(16) if args.model == "small" \
        else resnet18_specs(36)
    print(f"co-verifying {args.model} ({gops(specs):.3f} GOP) "
          f"oracle vs interpret...")

    fb_o = run_cnn(specs, backend="oracle", device=device)
    fb_i = run_cnn(specs, backend="interpret", congestion=CONG,
                   device=device)
    ok = True
    for name in ("act_0", "act_1"):
        a = fb_o.mem.buffers[name].array
        b = fb_i.mem.buffers[name].array
        err = float(np.max(np.abs(a - b)))
        ok &= err < 1e-3
        print(f"  DDR {name}: max |oracle - interpret| = {err:.2e}")
    print(f"  functional equivalence: {'PASS' if ok else 'FAIL'}")

    print("\n".join(congestion_report(fb_i)))

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
