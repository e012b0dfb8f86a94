"""High-level co-verification entry point — the user-facing FireBridge API.

One call takes a kernel (hardware) + oracle (golden model) + firmware
(host-side data movement / register protocol) through the full paper flow:

  1. firmware runs against the ORACLE backend        ("early model")
  2. firmware runs against the INTERPRET backend     ("RTL simulation")
  3. firmware runs against the COMPILED backend      ("deployment")
  4. three-way equivalence on final DDR state
  5. transaction profiling + optional online congestion emulation (§IV-C)
  6. register-protocol violation audit

The measured wall-clock of (2)+(4) is one "debug iteration" in the Fig. 5
reproduction (benchmarks/bench_debug_iteration.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.bridge import FireBridge
from repro_torch.core.congestion import CongestionConfig, CongestionResult
from repro_torch.core.equivalence import EquivalenceReport, compare_outputs


@dataclasses.dataclass
class CoverifyResult:
    equivalence: EquivalenceReport
    iteration_seconds: Dict[str, float]
    tx_summary: dict
    protocol_violations: List[str]
    congestion: Optional[CongestionResult] = None

    @property
    def passed(self) -> bool:
        return self.equivalence.passed and not self.protocol_violations


def coverify(firmware: Callable[[FireBridge, str], None],
             ops: Dict[str, dict],
             backends=("oracle", "interpret", "compiled"),
             tol: float = 1e-3,
             congestion: Optional[CongestionConfig] = None) -> CoverifyResult:
    """Run `firmware(bridge, backend)` once per backend on fresh bridges and
    diff the final DDR contents.

    `ops`: {name: dict(oracle=fn, interpret=fn, compiled=fn, burst_list=fn)}
    registered on each bridge before firmware runs.

    With `congestion` set, each bridge runs with the online link model
    (paper §IV-C) so stalls/makespan are produced during the launch; the
    returned `congestion` field is the last backend's live statistics.
    """
    final_state: Dict[str, dict] = {}
    iter_s: Dict[str, float] = {}
    last_bridge: Optional[FireBridge] = None
    violations: List[str] = []

    for be in backends:
        fb = FireBridge(congestion=congestion)
        for name, fns in ops.items():
            fb.register_op(name, **fns)
        t0 = time.perf_counter()
        firmware(fb, be)
        iter_s[be] = time.perf_counter() - t0
        final_state[be] = {n: b.array.copy() for n, b in fb.mem.buffers.items()}
        violations.extend(f"[{be}] {v}" for v in fb.log.violations)
        last_bridge = fb

    eq = compare_outputs(final_state, tol=tol)

    cong = None
    if congestion is not None and last_bridge is not None:
        cong = last_bridge.congestion_stats()

    return CoverifyResult(
        equivalence=eq,
        iteration_seconds=iter_s,
        tx_summary=last_bridge.log.summary() if last_bridge else {},
        protocol_violations=violations,
        congestion=cong,
    )
