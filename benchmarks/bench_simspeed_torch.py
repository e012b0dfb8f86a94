"""Simulator-speed benchmark on the PyTorch port (``repro_torch``): the
vectorized modeled-time hot path vs the retained scalar reference (ROADMAP
item 4 — iteration speed must keep pace with design size, the
FERIVer/ZynqParrot argument).

The workload is the 200-launch bridge fuzz scenario's recorded
arbitration stream: every burst batch that crossed ``LinkModel`` during
one fixed-seed run (fuzz perturbations already applied, so the stream is
deterministic).  One *scenario* replays that stream through a fresh
shared link the way the replay-backed regression tier consumes it —
build each batch, arbitrate it, log it, and take a trace-digest
checkpoint at launch granularity (every ``CHECKPOINT_EVERY`` batches,
the cadence the time-travel recorder and divergence bisection digest
at).  Two lanes:

* **scalar** — per-burst ``Transaction`` objects through
  ``LinkModel._submit_scalar`` plus the pre-vectorization digest, which
  re-rendered every canonical line and re-hashed the whole stream on
  each call (O(total) per checkpoint),
* **vector** — ``BurstBatch`` columns through ``LinkModel.submit_batch``
  (grant order, DoS draws and transfer latencies batched; lazy log
  segments) plus the lazy incremental digest (renders each line once,
  O(delta) per checkpoint).

An ``arb`` lane pair times arbitration alone (no checkpoints) so the
two contributions stay separable.  Both pipelines must produce
byte-identical digests at every checkpoint — asserted outside the timed
region — so the speedup is free: the ≥5x acceptance floor on the full
scenario is enforced here (``--check``, the CI simspeed lane), with the
floors and the captured workload's counts of the committed
``BENCH_simspeed.json``, which ``--check`` reads and never writes.  The modeled-time pipeline runs on the host; the
captured fuzz scenario's oracle launches run on ``--device``.

    PYTHONPATH=src python benchmarks/bench_simspeed_torch.py [--full]
    PYTHONPATH=src python benchmarks/bench_simspeed_torch.py --check
    PYTHONPATH=src python benchmarks/bench_simspeed_torch.py --selftest
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core.congestion import CongestionConfig, LinkModel
from repro_torch.core.transactions import (BURST_DTYPE, BurstBatch, Transaction,
                                     TransactionLog)

# One link config for the replayed stream: DoS active so the seeded
# draw-stream equivalence is exercised, not just the arithmetic.
CFG = CongestionConfig(dos_prob=0.05, seed=7)
FUZZ_SEED = 0
LAUNCHES = 200                  # ops in the captured fuzz scenario
CHECKPOINT_EVERY = 4            # ~1 digest per launch (859 batches/200)
SPEEDUP_FLOOR = 5.0             # acceptance: vector >= 5x scalar
SCN_PER_S_FLOOR = 2.0           # absolute floor for the CI lane (slow
                                # shared runners; local is far higher)
BENCH_PATH = Path(__file__).resolve().parents[1] / "BENCH_simspeed.json"

# A batch spec: parallel columns (times, engines, kinds, addrs, nbytes,
# tags) — neutral ground both pipelines build their native form from.
Spec = Tuple[List[float], List[str], List[str], List[int], List[int],
             List[str]]


def capture_workload(device="cuda") -> List[Spec]:
    """Record every arbitration batch of the 200-launch fuzz scenario by
    spying on both LinkModel entry points (the live path is batched; the
    spy keeps working if a caller still submits objects)."""
    from repro_torch.core.fuzz import ProtocolFuzzer
    specs: List[Spec] = []
    orig_s, orig_b = LinkModel.submit, LinkModel.submit_batch

    def spy_s(self, txs, log=None):
        specs.append(([t.time for t in txs], [t.engine for t in txs],
                      [t.kind for t in txs], [t.addr for t in txs],
                      [t.nbytes for t in txs], [t.tag for t in txs]))
        return orig_s(self, txs, log)

    def spy_b(self, batch, log=None):
        specs.append((batch.rec["time"].tolist(), list(batch.engine),
                      list(batch.kind), batch.rec["addr"].tolist(),
                      batch.rec["nbytes"].tolist(), list(batch.tag)))
        return orig_b(self, batch, log)

    LinkModel.submit, LinkModel.submit_batch = spy_s, spy_b
    try:
        fz = ProtocolFuzzer(seed=FUZZ_SEED, layers=("bridge",),
                            backends=("oracle",),
                            bridge_ops=(LAUNCHES, LAUNCHES + 1),
                            device=device)
        fz.run(1)
    finally:
        LinkModel.submit, LinkModel.submit_batch = orig_s, orig_b
    return specs


def eager_digest(log: TransactionLog) -> str:
    """The pre-vectorization ``TransactionLog.digest``, replicated: build
    every canonical line from scratch and hash the full stream — what
    each replay checkpoint paid before digests went lazy."""
    lines = [TransactionLog.canonical_line(t) for t in log.txs]
    lines += [f"violation: {v}" for v in log.violations]
    lines += [f"fault: {f}" for f in log.faults]
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def scenario_scalar(specs: List[Spec],
                    checkpoints: bool = True) -> List[str]:
    """The pre-vectorization pipeline: Transaction objects per burst
    through the scalar arbitration loop, eager digest per checkpoint."""
    lm = LinkModel(CFG)
    log = TransactionLog()
    sigs: List[str] = []
    for i, (times, engines, kinds, addrs, nbs, tags) in enumerate(specs):
        txs = [Transaction(t, e, k, a, nb, tg)
               for t, e, k, a, nb, tg in zip(times, engines, kinds, addrs,
                                             nbs, tags)]
        lm._submit_scalar(txs, log)
        if checkpoints and (i + 1) % CHECKPOINT_EVERY == 0:
            sigs.append(eager_digest(log))
    if checkpoints:
        sigs.append(eager_digest(log))
    return sigs


def scenario_vector(specs: List[Spec],
                    checkpoints: bool = True) -> List[str]:
    """The batched pipeline: column batches through submit_batch, lazy
    incremental digest per checkpoint."""
    lm = LinkModel(CFG)
    log = TransactionLog()
    sigs: List[str] = []
    for i, (times, engines, kinds, addrs, nbs, tags) in enumerate(specs):
        rec = np.zeros(len(times), dtype=BURST_DTYPE)
        rec["time"] = times
        rec["addr"] = addrs
        rec["nbytes"] = nbs
        lm.submit_batch(BurstBatch(rec, engines, kinds, tags), log)
        if checkpoints and (i + 1) % CHECKPOINT_EVERY == 0:
            sigs.append(log.digest())
    if checkpoints:
        sigs.append(log.digest())
    return sigs


def _best_s(fn, specs, checkpoints: bool, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(specs, checkpoints)
        best = min(best, time.perf_counter() - t0)
    return best


def measure(specs: List[Spec], reps: int) -> dict:
    """Scenarios/sec for both pipelines + the bit-exactness check."""
    sa = scenario_scalar(specs)                 # warmup + witness
    sb = scenario_vector(specs)
    assert sa == sb, "vectorized pipeline diverged from scalar reference"
    scalar_s = _best_s(scenario_scalar, specs, True, reps)
    vector_s = _best_s(scenario_vector, specs, True, reps)
    scalar_arb_s = _best_s(scenario_scalar, specs, False, reps)
    vector_arb_s = _best_s(scenario_vector, specs, False, reps)
    return {
        "batches": len(specs),
        "txs": int(sum(len(s[0]) for s in specs)),
        "checkpoints": len(sa),
        "scalar_scn_per_s": round(1.0 / scalar_s, 2),
        "vector_scn_per_s": round(1.0 / vector_s, 2),
        "speedup": round(scalar_s / vector_s, 2),
        "arb_speedup": round(scalar_arb_s / vector_arb_s, 2),
        "digest": sa[-1],
    }


def run(reps: int = 2, device="cuda") -> List[str]:
    """Quick mode for benchmarks/run_torch.py: CSV rows."""
    specs = capture_workload(device)
    m = measure(specs, reps)
    return [
        "lane,scenarios_per_sec,detail",
        f"scalar,{m['scalar_scn_per_s']},txs={m['txs']}",
        f"vector,{m['vector_scn_per_s']},txs={m['txs']}",
        f"speedup,{m['speedup']},floor={SPEEDUP_FLOOR}",
        f"arb_speedup,{m['arb_speedup']},no-checkpoint lane",
    ]


def selftest() -> None:
    """Deterministic output (no wall times): the fenced transcript of
    docs/performance.md.  A tiny synthetic workload through both
    pipelines; everything printed derives from modeled cycles only."""
    rng = np.random.default_rng(42)
    specs: List[Spec] = []
    t = 0.0
    for _ in range(8):
        n = int(rng.integers(4, 17))
        engs = [f"e{int(rng.integers(3))}" for _ in range(n)]
        t += float(rng.integers(0, 100))
        specs.append(([t] * n, engs, ["read"] * n,
                      [int(a) for a in rng.integers(0, 1 << 20, n)],
                      [int(b) for b in rng.integers(1, 4096, n)],
                      [""] * n))
    sa, sb = scenario_scalar(specs), scenario_vector(specs)
    print("simspeed selftest")
    print(f"workload: {len(specs)} batches, {sum(len(s[0]) for s in specs)} "
          f"bursts, {len(sa)} digest checkpoints")
    print(f"scalar final digest: {sa[-1][:16]}")
    print(f"vector final digest: {sb[-1][:16]}")
    print("checkpoint identity:", "OK" if sa == sb else "MISMATCH")
    assert sa == sb


def check(m: dict) -> List[str]:
    """The CI gate against the committed ``BENCH_simspeed.json``: the
    captured workload is the committed one (batches, bursts, digest
    checkpoints) and both pipelines clear the committed floors."""
    doc = json.loads(BENCH_PATH.read_text())
    problems = [f"workload {k}: {m[k]} != committed {v}"
                for k, v in doc["workload"].items()
                if k in m and m[k] != v]
    floors = doc["floors"]
    if m["speedup"] < floors["speedup"]:
        problems.append(f"speedup {m['speedup']} < floor "
                        f"{floors['speedup']}")
    if m["vector_scn_per_s"] < floors["vector_scn_per_s"]:
        problems.append(f"vector {m['vector_scn_per_s']} scenarios/sec < "
                        f"floor {floors['vector_scn_per_s']}")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the captured scenario's oracle "
                         "launches (cuda or cpu)")
    args, _ = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    if "--selftest" in argv:
        selftest()
        return 0
    reps = 5 if "--full" in argv else 2
    specs = capture_workload(device)
    m = measure(specs, reps)
    print(f"workload: {m['batches']} batches, {m['txs']} txs, "
          f"{m['checkpoints']} digest checkpoints "
          f"({LAUNCHES}-launch fuzz scenario, seed={FUZZ_SEED})")
    print(f"scalar: {m['scalar_scn_per_s']:.2f} scenarios/sec")
    print(f"vector: {m['vector_scn_per_s']:.2f} scenarios/sec")
    print(f"speedup: {m['speedup']:.2f}x (floor {SPEEDUP_FLOOR}x); "
          f"arbitration-only lane {m['arb_speedup']:.2f}x")
    out = next((argv[i + 1] for i, a in enumerate(argv)
                if a == "--json" and i + 1 < len(argv)), None)
    if out:
        point = {"date": time.strftime("%Y-%m-%d")}
        point.update({k: m[k] for k in ("scalar_scn_per_s",
                                        "vector_scn_per_s", "speedup",
                                        "arb_speedup")})
        path = Path(out)
        doc = json.loads(path.read_text()) if path.exists() else {
            "bench": "simspeed",
            "unit": "scenarios/sec: modeled-time pipeline (batch build -> "
                    "arbitrate -> log -> per-launch digest checkpoint) "
                    "over the recorded 200-launch fuzz arbitration stream",
            "workload": {"fuzz_seed": FUZZ_SEED, "launches": LAUNCHES,
                         "batches": m["batches"], "txs": m["txs"],
                         "checkpoints": m["checkpoints"]},
            "floors": {"speedup": SPEEDUP_FLOOR,
                       "vector_scn_per_s": SCN_PER_S_FLOOR},
            "trajectory": [],
        }
        doc["trajectory"].append(point)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {path}")
    if "--check" in argv:
        problems = check(m)
        for p in problems:
            print(f"  FAIL {p}")
        print("simspeed check:", "FAIL" if problems else "PASS")
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
