#!/usr/bin/env python3
"""Serves one model through the ``serve`` phase of ``chip_smoke.py`` of one
or more checkouts of the PyTorch port, in turns, on one GPU.

    python3 time_serve.py [--arch ARCH] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one).  For each, in the
order given, a process of its own runs that checkout's
``chip_smoke.phase_env``, ``phase_build`` and ``phase_serve(card, ARCH)``
(default moonshot-v1-16b-a3b, the phase ``serve_moe``) and prints one JSON
line: the tree, the serving wall seconds, the median decode step, the
prefill time, the log digest and the number of tokens served.  Two trees
given as A B B A are compared on one card; a reading is worth only as much
as the spread between the two runs of one tree.  Exits 1 unless every run
served the same tokens with the same log digest, 2 without a CUDA device.
The last line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

CHILD = ("import sys; sys.path[:0] = ['.', 'src']; import torch; "
         "import chip_smoke as cs; "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "card = cs.phase_env(); cs.phase_build(); "
         "cs.phase_serve(card, {arch!r})")
KEEP = ("serve_s", "decode_step_ms_median", "decode_steps", "prefill_ms",
        "log_digest", "tokens_out", "completed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_serve: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    for tree in args.trees:
        p = subprocess.run([sys.executable, "-c",
                            CHILD.format(arch=args.arch)],
                           cwd=Path(tree), capture_output=True, text=True,
                           timeout=1200)
        rows = [json.loads(ln) for ln in p.stdout.splitlines()
                if ln.startswith("{")]
        row = next((r for r in rows if r.get("arch") == args.arch
                    and "serve_s" in r), None)
        if p.returncode or row is None:
            print(json.dumps({"tree": tree, "rc": p.returncode,
                              "stderr": p.stderr[-3000:]}))
            return 1
        out = {"tree": tree, **{k: row[k] for k in KEEP}}
        out["tokens_sha256"] = hashlib.sha256(json.dumps(
            row["requests"]).encode()).hexdigest()[:16]
        runs.append(out)
        print(json.dumps(out), flush=True)
    same = len({(r["log_digest"], r["tokens_out"], r["tokens_sha256"])
                for r in runs}) == 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"same_tokens_and_digest": same,
                      "card": smi.stdout.strip()}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
