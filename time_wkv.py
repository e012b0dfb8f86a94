#!/usr/bin/env python3
"""Times the WKV-6 scan (B6) of one checkout's PyTorch port on one GPU.

    python3 time_wkv.py [--src DIR] [--reps N]

Imports ``repro_torch`` from DIR (default: the ``src`` beside this file),
builds that checkout's ``wkv_scan`` kernel into its own ``build/``, and
prints one JSON object per shape: the median CUDA-event time of one
``kernel.wkv_scan`` call (host path included, as ``chip_smoke.py`` times
its rows) and the device time of the call's launches (``torch.profiler``).
The shapes are rwkv6-7b's heads (H=64, K=64) at every prompt length that
``chip_smoke.py`` serves (256-1536) and train_ssm's 1024.  Only the
wrapper's public signature is used, so two checkouts can be compared on
one card by running this file against each in turns (A, B, B, A) on the
same machine.  The last line names the card and its power limit.
Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

LENGTHS = (256, 512, 640, 896, 1024, 1152, 1408, 1536)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv6_wkv import kernel as WKVK

    if not torch.cuda.is_available():
        print("time_wkv: no CUDA device", file=sys.stderr)
        return 2
    for L in LENGTHS:
        B, H, K = 1, 64, 64
        rng = np.random.default_rng(B * 31 + L + H * 7 + K)
        g = lambda *sh: torch.from_numpy(
            rng.normal(size=sh).astype(np.float32)).cuda()
        r, k, v = g(B, L, H, K), g(B, L, H, K), g(B, L, H, K)
        w = torch.exp(-torch.exp(g(B, L, H, K)))
        u = g(H, K) * 0.5
        call = lambda: WKVK.wkv_scan(r, k, v, w, u, chunk=16, hb=8)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        dev = sum(ev.device_time_total for ev in prof.key_averages()
                  if ev.device_time_total > 0) / 5 / 1e3
        print(json.dumps({"src": args.src, "shape": [B, L, H, K],
                          "kernel_ms": statistics.median(times),
                          "kernel_ms_quartiles": statistics.quantiles(
                              times, n=4)[::2],
                          "device_ms": dev or None}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
