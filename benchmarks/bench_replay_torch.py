"""Debug-iteration wall time on the PyTorch port (``repro_torch``):
checkpointed window replay vs full re-run, and replay-backed shrink vs
re-run-per-prefix shrink (core/replay.py — the paper's 50x debug-iteration
claim, measured on this stack), the backends on ``--device``.

Two lanes:

* **debug iteration** — one long fixed-seed fault-injected fuzz scenario
  (200 launches; the 200-scenario debug workload).  The iteration under
  test is "show me the device state at launch k": the baseline
  re-executes ops 1..k from time zero, the time-travel lane restores the
  nearest transaction-boundary checkpoint and replays only the window.
  Both materialize bit-identical state (core/replay.py contract), so the
  comparison is pure economics; ``events`` counts actually-executed
  timeline ops per iteration (deterministic), ``ms`` is wall time.
* **shrink** — ``ProtocolFuzzer.shrink`` on a scenario whose planted bug
  fires only on a LATE launch, with and without prefix replay: the
  legacy loop re-runs the whole prefix per candidate (quadratic in ops),
  the replay loop records once and restores checkpoints (linear).

``run()`` returns the rows with the wall readings in them; ``gate()``
holds the window replay to its >= 5x wall speed-up over the full re-run,
and ``main()`` exits 1 below it.

    PYTHONPATH=src:. python benchmarks/bench_replay_torch.py [--full] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core import ProtocolFuzzer

OPS = 200                       # launches in the long fuzz scenario
INSPECT_AT = 150                # the debug iteration targets launch #150
CHECKPOINT_EVERY = 8            # scenario ops between checkpoints
SHRINK_OPS_QUICK, SHRINK_OPS_FULL = 24, 48
EVENTS_PER_OP = ProtocolFuzzer._BRIDGE_EVENTS_PER_OP
MIN_WINDOW_SPEEDUP = 5.0        # the debug-iteration gate (wall clock)


def _median_ms(fn, repeats: int) -> float:
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


_TABLE_CACHE: dict = {}


def _late_bug_table(tile: int = ProtocolFuzzer.TILE, device="cuda") -> dict:
    """Backend table whose interpret lane diverges ONLY for size-64
    launches — so the failing prefix sits wherever the scenario first
    draws a 64 and shrink must walk there.  Built once: both shrink lanes
    share the compiled callables (only the walk economics differ).  One
    table a device."""
    key = str(resolve_device(device))
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    from repro_torch.kernels.systolic_matmul.sweep import matmul_backends
    table = matmul_backends(tile=tile, device=device)
    good = table["interpret"]

    def buggy(a, b):
        out = np.array(good(a, b))
        if a.shape[0] == 64:
            out[1, 2] += 1.0
        return out
    _TABLE_CACHE[key] = dict(table, interpret=buggy)
    return _TABLE_CACHE[key]


def _late_bug_fuzzer(n_ops: int, device="cuda"):
    """Fuzzer + a constructed scenario whose ONLY size-64 launch (where
    the planted bug fires) sits at 3/4 of the op list — the position
    shrink must walk to."""
    from repro_torch.core.fuzz import Scenario
    fz = ProtocolFuzzer(seed=0, layers=("bridge",),
                        backends=("oracle", "interpret"),
                        mm_table=_late_bug_table(device=device),
                        bridge_ops=(n_ops, n_ops + 1), device=device)
    bug_at = (3 * n_ops) // 4
    sizes = [(32, 48)[j % 2] for j in range(n_ops)]
    sizes[bug_at - 1] = 64
    scn = Scenario(0, "bridge", [("launch", s) for s in sizes])
    return fz, scn, bug_at


def run(quick: bool = True, device="cuda") -> list[str]:
    repeats = 3 if quick else 7
    rows = ["case,ops,events,ms,speedup"]

    # ---- debug iteration: state at launch INSPECT_AT of a 200-op
    # fault-injected scenario (single backend: the run under debug)
    fz = ProtocolFuzzer(seed=0, layers=("bridge",), backends=("oracle",),
                        bridge_ops=(OPS, OPS + 1), device=device)
    scn = fz.scenario(0)
    # time-travel lane: record ONCE with checkpoints, then window-replay
    sess, rec = fz._record_bridge_scenario(scn, "oracle", CHECKPOINT_EVERY)
    # baseline lane: same recording with NO interior checkpoints — a
    # prefix probe must re-execute everything from time zero
    sess0, rec0 = fz._record_bridge_scenario(scn, "oracle", OPS + 1)
    k = INSPECT_AT * EVENTS_PER_OP

    sess0.ops_applied = 0
    full_ms = _median_ms(lambda: sess0.replay(rec0, k, k), repeats)
    full_events = sess0.ops_applied // repeats

    sess.ops_applied = 0
    win_ms = _median_ms(lambda: sess.replay(rec, k, k), repeats)
    win_events = sess.ops_applied // repeats

    speedup = full_ms / max(win_ms, 1e-9)
    rows.append(f"full_rerun,{INSPECT_AT},{full_events},{full_ms:.1f},1.0")
    rows.append(f"window_replay,{INSPECT_AT},{win_events},{win_ms:.1f},"
                f"{speedup:.1f}")

    # ---- shrink with a late-firing planted bug
    n_shrink = SHRINK_OPS_QUICK if quick else SHRINK_OPS_FULL
    _, _, bug_at = _late_bug_fuzzer(n_shrink, device)
    table = _late_bug_table(device=device)
    for size in ProtocolFuzzer.SIZES:   # compile outside the timed lanes
        x = np.zeros((size, size), np.float32)
        table["interpret"](x, x), table["compiled"](x, x)

    def shrink_once(use_replay: bool) -> None:
        f, s, _ = _late_bug_fuzzer(n_shrink, device)
        sub, res = f.shrink(s, use_replay=use_replay)
        assert not res.ok and len(sub.ops) == bug_at

    reps = 1 if quick else 3
    slow_ms = _median_ms(lambda: shrink_once(False), reps)
    fast_ms = _median_ms(lambda: shrink_once(True), reps)
    # events: the rerun lane re-executes every prefix 1..bug_at on every
    # backend (exact); the replay lane's count is record + O(log n)
    # checkpoint-window probes + one authoritative prefix — report "-"
    # rather than an estimate
    rows.append(f"shrink_rerun_per_prefix,{n_shrink},"
                f"{bug_at * (bug_at + 1) // 2 * EVENTS_PER_OP * 2},"
                f"{slow_ms:.1f},1.0")
    rows.append(f"shrink_prefix_replay,{n_shrink},-,"
                f"{fast_ms:.1f},{slow_ms / max(fast_ms, 1e-9):.1f}")
    return rows


def run_full(device="cuda") -> list[str]:
    return run(quick=False, device=device)


def gate(rows: list[str]) -> tuple[bool, str]:
    """(held, verdict row) of the window replay's wall speed-up over the
    full re-run against ``MIN_WINDOW_SPEEDUP``, read from ``run()``'s
    rows."""
    by = {r.split(",")[0]: r.split(",") for r in rows[1:]}
    speedup = float(by["window_replay"][4])
    held = speedup >= MIN_WINDOW_SPEEDUP
    return held, (f"gate,window_replay_speedup,{speedup},"
                  f">={MIN_WINDOW_SPEEDUP},{'held' if held else 'FAILED'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run(quick=not args.full, device=device)
    held, verdict = gate(rows)
    print("\n".join(rows + [verdict]))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
