"""Fig. 9 reproduction: memory-access-pattern heatmaps (address x time) for
a small CNN and ResNet-18 through the bridge.  The ping-pong activation
buffering of the firmware is visible as alternating address bands in the
input-read heatmap, and the weights stream as a monotonically advancing
band — the two signatures the paper calls out.  On the PyTorch port
(``repro_torch``): the oracle matmul runs on ``device``; the heatmaps are
written under benchmarks/artifacts/torch/.

    PYTHONPATH=src:. python benchmarks/bench_access_patterns_torch.py \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from benchmarks.cnn_driver_torch import (gops, resnet18_specs, run_cnn,
                                         small_cnn_specs)
from repro_torch._device import resolve_device

ART = Path(__file__).resolve().parent / "artifacts" / "torch"


def run(device="cuda") -> list[str]:
    rows = ["case,model,gop,reads,writes,heatmap_file"]
    for name, specs in (("small_cnn", small_cnn_specs(16)),
                        ("resnet18", resnet18_specs(36))):
        fb = run_cnn(specs, backend="oracle", device=device)
        reads = sum(1 for t in fb.log.txs if t.kind == "read")
        writes = sum(1 for t in fb.log.txs if t.kind == "write")
        out = ART / f"fig9_heatmap_{name}.txt"
        out.parent.mkdir(parents=True, exist_ok=True)
        txt = ["# address (vertical, high->low) x time (horizontal)",
               "## reads", fb.log.render_heatmap(24, 72, kind="read"),
               "## writes", fb.log.render_heatmap(24, 72, kind="write")]
        out.write_text("\n".join(txt))
        rows.append(f"fig9,{name},{gops(specs):.3f},{reads},{writes},"
                    f"{out.name}")
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
