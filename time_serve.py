#!/usr/bin/env python3
"""Runs one phase of ``chip_smoke.py`` of one or more checkouts of the
PyTorch port, in turns, on one GPU.

    python3 time_serve.py [--phase serve|train_ssm|sharded_serve]
                          [--arch ARCH] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one).  For each, in the
order given, a process of its own runs that checkout's
``chip_smoke.phase_env``, ``phase_build`` and then the phase, and prints
one JSON line:

  * ``serve`` (default): ``phase_serve(card, ARCH)`` (default
    moonshot-v1-16b-a3b, the phase ``serve_moe``): the serving wall
    seconds, the median decode step, the prefill time, the log digest and
    the number of tokens served;
  * ``train_ssm``: ``phase_train_ssm(card)``: for each config its one
    timed ``make_train_step`` step, the step's scan launches, its loss and
    ``max_memory_allocated``;
  * ``sharded_serve``: ``phase_serve(card, moonshot-v1-16b-a3b)``, whose
    tokens it is held to, then ``sharded_serve(card)`` on a one-rank NCCL
    group: the median decode step of each of its engines
    (``decode_profile``).

Two trees given as A B B A are compared on one card; a reading is worth
only as much as the spread between the two runs of one tree.  Exits 1
unless every run of ``serve`` served the same tokens with the same log
digest (or a run failed), 2 without a CUDA device.  The last line names
the card and its power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HEAD = ("import sys, json; sys.path[:0] = ['.', 'src']; import torch; "
        "import chip_smoke as cs; "
        "torch.backends.cuda.matmul.allow_tf32 = False; "
        "card = cs.phase_env(); cs.phase_build(); ")
CHILD = {
    "serve": HEAD + "cs.phase_serve(card, {arch!r})",
    "train_ssm": HEAD + "cs.phase_train_ssm(card)",
    # serve_moe first: sharded_serve holds its tokens to serve_moe's
    "sharded_serve": HEAD + (
        "cs.phase_serve(card, 'moonshot-v1-16b-a3b'); "
        "import tempfile, torch.distributed as dist; "
        "d = tempfile.mkdtemp(dir='build'); "
        "dist.init_process_group('nccl', store=dist.FileStore(d + '/s', 1), "
        "rank=0, world_size=1); out = cs.sharded_serve(card); "
        "dist.destroy_process_group(); "
        "print(json.dumps({{'phase': 'sharded_serve', "
        "'decode_ms_median': {{k: v['decode_ms_median'] for k, v in "
        "out['decode_profile'].items()}}}}))"),
}
KEEP = ("serve_s", "decode_step_ms_median", "decode_steps", "prefill_ms",
        "log_digest", "tokens_out", "completed")


def pick(phase: str, arch: str, rows: list):
    """The run's reading from the child's JSON lines (None: missing)."""
    if phase == "serve":
        row = next((r for r in rows if r.get("arch") == arch
                    and "serve_s" in r), None)
        if row is None:
            return None
        out = {k: row[k] for k in KEEP}
        out["tokens_sha256"] = hashlib.sha256(json.dumps(
            row["requests"]).encode()).hexdigest()[:16]
        return out
    if phase == "train_ssm":
        got = {r["arch"]: {"step_ms": r["step_ms"],
                           "step_launches": {k: v for k, v in
                                             r["step_launches"].items() if v},
                           "loss": r["step_metrics"]["loss"],
                           "max_memory_allocated":
                               r["max_memory_allocated"]}
               for r in rows if r.get("phase") == "train_ssm"}
        return got or None
    return next((r for r in rows if r.get("phase") == "sharded_serve"),
                None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=sorted(CHILD), default="serve")
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
                            CHILD[args.phase].format(arch=args.arch)],
                           cwd=Path(tree), capture_output=True, text=True,
                           timeout=1200)
        rows = [json.loads(ln) for ln in p.stdout.splitlines()
                if ln.startswith("{")]
        got = pick(args.phase, args.arch, rows)
        if p.returncode or got is None:
            print(json.dumps({"tree": tree, "rc": p.returncode,
                              "stderr": p.stderr[-3000:]}))
            return 1
        out = {"tree": tree, "phase": args.phase, **got}
        runs.append(out)
        print(json.dumps(out), flush=True)
    last = {}
    if args.phase == "serve":
        last["same_tokens_and_digest"] = len(
            {(r["log_digest"], r["tokens_out"], r["tokens_sha256"])
             for r in runs}) == 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({**last, "card": smi.stdout.strip()}))
    return 0 if last.get("same_tokens_and_digest", True) else 1


if __name__ == "__main__":
    sys.exit(main())
