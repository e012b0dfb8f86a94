"""Time-travel debugging walkthrough (core/replay.py) on the PyTorch port
(``repro_torch``): record a
fault-injected co-verification run, replay an arbitrary window
bit-identically, then let a failing sweep localize its own divergence by
checkpoint bisection.

Every line printed is deterministic (modeled clocks, seeded faults,
content digests — no wall time) and is the fenced transcript of
docs/replay.md, but for the content hash of the float output buffer
``c``: it hashes the bytes of a float matmul result, which differ in their
last bits from one matmul implementation to another.

    PYTHONPATH=src python examples/time_travel_debug_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import CongestionConfig, CoVerifySession, FireBridge
from repro_torch.core import replay as rp
from repro_torch.core.fuzz import FaultPlan, planted_bug_table
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                 matmul_firmware)

CONG = CongestionConfig(dos_prob=0.05, seed=7)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the matmul backends run on (cuda or cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- 1. record a fault-injected run as a deterministic timeline
    table = matmul_backends(tile=16, device=device, jit=False)

    def factory():
        fb = FireBridge(congestion=CONG, fault_plan=FaultPlan(seed=3))
        fb.register_op("mm", **table)
        return fb

    sess = rp.DebugSession(factory, checkpoint_interval=3, label="run")

    def program(rec):
        for j, size in enumerate((32, 48, 32)):
            rng = np.random.default_rng(size)
            a = rng.normal(size=(size, size)).astype(np.float32)
            b = rng.normal(size=(size, size)).astype(np.float32)
            rec.do("alloc", f"a{j}", a.shape, np.float32)
            rec.do("alloc", f"b{j}", b.shape, np.float32)
            rec.do("alloc", f"c{j}", (size, size), np.float32)
            rec.do("host_write", f"a{j}", a)
            rec.do("host_write", f"b{j}", b)
            rec.do("launch", "mm", "oracle", (f"a{j}", f"b{j}"),
                   (f"c{j}",), "mm", None, {})

    rec = sess.record(program)
    print(f"recorded: {rec.n_ops} ops, "
          f"checkpoints at {[c.op_index for c in rec.checkpoints]}, "
          f"{len(rec.lines)} trace lines, "
          f"{len(rec.preamble)} construction line(s)")
    print(f"log digest: {rec.log_digest[:16]}")

    # ---- 2. bit-identical window replay from the nearest checkpoint
    lo, hi = 10, rec.n_ops
    w = sess.replay(rec, lo, hi)
    print(f"replayed window [{lo}, {hi}) from checkpoint "
          f"@op {w.from_checkpoint}: "
          f"{'IDENTICAL' if w.lines == rec.window_lines(lo, hi) else 'DIVERGED'}"
          f" ({len(w.lines)} lines, digest "
          f"{'match' if w.digest() == rec.window_digest(lo, hi) else 'MISMATCH'})")

    # ---- 3. a failing sweep bisects its own divergence
    sweep = CoVerifySession(matmul_firmware, congestion=CONG)
    sweep.register_op("mm", **planted_bug_table(tile=16, device=device))
    sweep.add_sweep("mm", ("oracle", "interpret"),
                    [{"size": 32, "tile": 16}])
    report = sweep.run(max_workers=1)
    print(f"sweep passed: {report.passed}")
    (d,) = report.divergences.values()
    print(d.render())


if __name__ == "__main__":
    main()
