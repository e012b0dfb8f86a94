#!/usr/bin/env python3
"""Times one cell of the PyTorch port's dry run with and without the
program counter's reuse of output metadata, each run in a process of its
own, on the CPU (the dry run needs no device).

    python3 time_dryrun.py [--arch ARCH] [--shape SHAPE]
                           [--order plain,reuse,...]

``plain`` runs every op's shape function on meta tensors; ``reuse`` is the
dry run as ``python -m repro_torch.launch.dryrun`` runs it (see
``ProgramCounter``), both on the 16 x 16 mesh.  Prints one JSON line a run
(its ``lower_s`` and ``compile_s``, the time to build the fake state and
the time of the counted step) and a last line saying whether every run
wrote the same record (memory, profile, FLOP count and roofline).  Exits 1
if they differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
CHILD = """
import hashlib, json, sys
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
arch, shape, mode = sys.argv[1:4]
flags = dryrun.flags_from_args(dryrun.parser().parse_args([]))
rec = dryrun.measure_cell(get_config(arch), SHAPES[shape],
                          make_production_mesh(), flags,
                          reuse_shapes=mode == "reuse")
body = json.dumps({k: rec[k] for k in ("memory_analysis", "profile",
                   "cost_analysis_raw", "roofline")}, sort_keys=True)
print(json.dumps({"lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                  "record_sha256": hashlib.sha256(
                      body.encode()).hexdigest()[:16]}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--order", default="plain,reuse,reuse,plain")
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    digests = set()
    for mode in args.order.split(","):
        if mode not in ("plain", "reuse"):
            ap.error(f"--order: {mode!r} is neither plain nor reuse")
        p = subprocess.run([sys.executable, "-c", CHILD, args.arch,
                            args.shape, mode], env=env, capture_output=True,
                           text=True)
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr)
            return p.returncode
        run = json.loads(p.stdout.splitlines()[-1])
        digests.add(run["record_sha256"])
        print(json.dumps({"arch": args.arch, "shape": args.shape,
                          "mode": mode, **run}), flush=True)
    print(json.dumps({"same_record": len(digests) == 1,
                      "cpus": os.cpu_count()}))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
