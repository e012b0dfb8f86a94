"""Fig. 7 reproduction on the PyTorch port (``repro_torch``): runtime and
peak memory of FireBridge verification vs FPGA prototyping for HLS4ML-style
cascaded dense networks of growing width, until the design no longer fits
the ZCU102.

Measured side: wall time + tracemalloc peak of a full bridge verification
(oracle vs interpret backends, on ``device``) of an N-wide 4-layer
16-bit-quantized dense cascade.  ``tracemalloc`` sees host allocations
only, so the last column, ``device_peak_gb``, is the card's
``torch.cuda.max_memory_allocated`` over the same verification, reset for
each width, above what the process held on the card when it began (0 on
the CPU).  FPGA side modeled from the paper (Vivado HLS+synth minutes and
EDA peak memory), labeled accordingly: those are the paper's figures, not
measurements of this machine.

    PYTHONPATH=src:. python benchmarks/bench_hls4ml_scaling_torch.py \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device, to_device
from repro_torch.core import coverify
from repro_torch.kernels.systolic_matmul import ref as mm_ref
from repro_torch.kernels.systolic_matmul.kernel import matmul as mm_kernel

WIDTHS = [32, 64, 128, 256, 512]
ZCU102_DSP = 2520
# paper-modeled Vivado flow: minutes and GB vs width (fails past the DSPs)
FPGA_MIN = {32: 22, 64: 31, 128: 55, 256: 96, 512: None}
FPGA_GB = {32: 6.5, 64: 8.0, 128: 11.0, 256: 18.0, 512: None}


def verify_cascade(width: int, device="cuda") -> tuple[float, float, float]:
    """(wall s, host tracemalloc peak GB, device peak GB) of one
    verification of the ``width``-wide cascade."""
    dev = resolve_device(device)
    rng = np.random.default_rng(width)
    layers = 4
    x = rng.normal(size=(8, width)).astype(np.float32)
    ws = [rng.normal(size=(width, width)).astype(np.float32) / np.sqrt(width)
          for _ in range(layers)]

    def quant16(v):     # hls4ml ap_fixed<16,6>-style quantization
        return np.round(v * 1024) / 1024

    def firmware(fb, backend):
        fb.mem.alloc("x", x.shape, np.float32)
        fb.mem.host_write("x", x)
        cur = "x"
        for i, w in enumerate(ws):
            fb.mem.alloc(f"w{i}", w.shape, np.float32)
            fb.mem.host_write(f"w{i}", quant16(w))
            fb.mem.alloc(f"y{i}", x.shape, np.float32)
            fb.launch("dense", backend, [cur, f"w{i}"], [f"y{i}"])
            cur = f"y{i}"

    tile = min(32, width)
    ops = {"dense": dict(
        oracle=lambda a, w: np.maximum(mm_ref.matmul_ref(
            to_device(a, dev), to_device(w, dev)).cpu().numpy(), 0.0),
        interpret=lambda a, w: np.maximum(mm_kernel(
            to_device(np.pad(a, ((0, (-a.shape[0]) % tile), (0, 0))), dev),
            to_device(w, dev), bm=tile, bn=tile,
            bk=tile).cpu().numpy()[:a.shape[0]], 0.0),
    )}
    on_card = dev.type == "cuda"
    held = 0
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    tracemalloc.start()
    t0 = time.perf_counter()
    res = coverify(firmware, ops, backends=("oracle", "interpret"), tol=1e-3)
    dt = time.perf_counter() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    dev_peak = (torch.cuda.max_memory_allocated(dev) - held) / 1e9 \
        if on_card else 0.0
    assert res.passed
    return dt, peak / 1e9, dev_peak


def run(device="cuda") -> list[str]:
    rows = ["case,width,dsp_estimate,fits_zcu102,firebridge_s,"
            "firebridge_peak_gb,fpga_s(modeled),fpga_peak_gb(modeled),"
            "device_peak_gb"]
    for w in WIDTHS:
        dsp = w * 4          # ~1 DSP per MAC column per layer (16-bit)
        fits = dsp <= ZCU102_DSP
        dt, peak, dev_peak = verify_cascade(w, device)
        fpga_s = FPGA_MIN[w] * 60 if FPGA_MIN[w] else "DNF"
        fpga_g = FPGA_GB[w] if FPGA_GB[w] else "DNF"
        rows.append(f"fig7,{w},{dsp},{fits},{dt:.2f},{peak:.3f},"
                    f"{fpga_s},{fpga_g},{dev_peak:.6f}")
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
