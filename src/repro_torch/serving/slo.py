"""Per-run latency-SLO report for open-loop serving (modeled cycles) —
the port of ``repro.serving.slo`` (value-free; one engine or a
``ClusterServingEngine``).

After an open-loop run (``serving/arrivals.py``) every completed request
carries its lifecycle timestamps on the engine's modeled clock:

  arrival  — when the open-loop source emitted it (from the trace)
  submit   — when the doorbell rang (>= arrival; equal unless the loop
             was busy stepping)
  admit    — when admission control granted a slot + KV pages (queueing
             delay = admit - arrival: the oversubscription signal)
  first    — when prefill emitted the first token (TTFT = first - arrival)
  done     — when the last token retired

``SLOReport.from_run`` collects them into per-request rows plus the SLO
summary: p50/p99 time-to-first-token, p50/p99 inter-token latency, and
tokens per kilocycle over the run horizon.  Everything is deterministic
(modeled cycles, not wall clock), so reports digest:

* ``digest()`` — full witness over rows AND token streams: identical
  across backends and across reruns of one configuration;
* ``tokens_digest()`` — token streams only: additionally identical across
  1/2/4-device scales, where modeled *timing* legitimately differs but
  generated tokens must not (the cross-scale tier in
  tests/test_serving_slo.py).

The reference's ``benchmarks/bench_serving.py`` gates the committed
``BENCH_serving.json`` trajectory on these numbers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RequestStats", "SLOReport", "percentile"]


def percentile(xs: List[float], q: float) -> float:
    """Deterministic linear-interpolation percentile (numpy's default
    method, implemented locally so the report never drifts with numpy
    versions).  Empty input -> 0.0."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = (len(s) - 1) * q / 100.0
    f = math.floor(k)
    c = min(f + 1, len(s) - 1)
    return s[f] + (s[c] - s[f]) * (k - f)


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """One completed request's lifecycle on the modeled clock."""
    rid: int
    t_arrival: float
    t_submit: float
    t_admit: float
    t_first: float
    t_done: float
    tokens: Tuple[int, ...]

    @property
    def ttft(self) -> float:
        """Time to first token, measured from *arrival* — queueing delay
        under load is part of the user-visible latency."""
        return self.t_first - self.t_arrival

    @property
    def queueing(self) -> float:
        return self.t_admit - self.t_arrival

    @property
    def itl(self) -> float:
        """Mean inter-token latency (0 for single-token requests)."""
        n = len(self.tokens)
        return (self.t_done - self.t_first) / (n - 1) if n > 1 else 0.0


@dataclasses.dataclass
class SLOReport:
    """Per-cell SLO readout of one open-loop run."""
    stats: List[RequestStats]
    horizon: float                      # final modeled clock
    deferrals: int                      # pool admission denials (retries)
    rejected: int                       # doorbell-time protocol rejections
    label: str = "serving"

    @classmethod
    def from_run(cls, trace: Any, target: Any,
                 label: str = "serving") -> "SLOReport":
        """Collect the report from a drained engine or cluster plus the
        arrival trace that drove it (the trace carries arrival times; the
        engine carries the admission/first/done stamps)."""
        t_arrival = {a.rid: a.time for a in trace.arrivals}
        stats = []
        for rid, req in sorted(target.requests.items()):
            if not req.done:
                continue
            stats.append(RequestStats(
                rid, t_arrival.get(rid, req.t_submit), req.t_submit,
                req.t_admit, req.t_first, req.t_done,
                tuple(int(t) for t in req.out_tokens)))
        engines = getattr(target, "engines", None) or [target]
        deferrals = sum(e.kv_pool.deferrals for e in engines
                        if e.kv_pool is not None)
        n_violations = len(target.violations) if hasattr(
            target, "violations") else len(target.mem.log.violations)
        return cls(stats, float(target.clock), deferrals, n_violations,
                   label=label)

    # ------------------------------------------------------------- metrics
    @property
    def completed(self) -> int:
        return len(self.stats)

    @property
    def total_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.stats)

    def p50_ttft(self) -> float:
        return percentile([s.ttft for s in self.stats], 50.0)

    def p99_ttft(self) -> float:
        return percentile([s.ttft for s in self.stats], 99.0)

    def p50_itl(self) -> float:
        return percentile([s.itl for s in self.stats if len(s.tokens) > 1],
                          50.0)

    def p99_itl(self) -> float:
        return percentile([s.itl for s in self.stats if len(s.tokens) > 1],
                          99.0)

    def tokens_per_kcycle(self) -> float:
        """Throughput over the run horizon, tokens per 1000 modeled
        cycles."""
        return (self.total_tokens / self.horizon * 1000.0
                if self.horizon > 0 else 0.0)

    # ---------------------------------------------------------------- rows
    def to_rows(self) -> List[str]:
        """Per-request CSV rows (sorted by rid) + one summary row —
        the SLO table schema documented in docs/serving.md."""
        rows = ["rid,t_arrival,t_admit,t_first,t_done,"
                "queue_cycles,ttft_cycles,itl_cycles,tokens"]
        for s in self.stats:
            rows.append(f"{s.rid},{s.t_arrival:.1f},{s.t_admit:.1f},"
                        f"{s.t_first:.1f},{s.t_done:.1f},"
                        f"{s.queueing:.1f},{s.ttft:.1f},{s.itl:.1f},"
                        f"{len(s.tokens)}")
        rows.append(self.summary_row())
        return rows

    def summary_row(self) -> str:
        return (f"summary,completed={self.completed},"
                f"deferrals={self.deferrals},rejected={self.rejected},"
                f"p50_ttft={self.p50_ttft():.1f},"
                f"p99_ttft={self.p99_ttft():.1f},"
                f"p50_itl={self.p50_itl():.1f},"
                f"p99_itl={self.p99_itl():.1f},"
                f"tok_per_kcyc={self.tokens_per_kcycle():.3f}")

    def summary(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "completed": self.completed,
            "total_tokens": self.total_tokens,
            "horizon": round(self.horizon, 1),
            "deferrals": self.deferrals,
            "rejected": self.rejected,
            "p50_ttft": round(self.p50_ttft(), 1),
            "p99_ttft": round(self.p99_ttft(), 1),
            "p50_itl": round(self.p50_itl(), 1),
            "p99_itl": round(self.p99_itl(), 1),
            "tokens_per_kcycle": round(self.tokens_per_kcycle(), 3),
        }

    # ------------------------------------------------------------- digests
    def digest(self) -> str:
        """Full determinism witness: SLO rows + token streams.  Identical
        across backends (oracle/interpret/compiled) and reruns of one
        configuration; NOT across device counts (modeled timing differs
        per scale — use ``tokens_digest`` there)."""
        h = hashlib.sha256()
        for row in self.to_rows():
            h.update(row.encode())
            h.update(b"\n")
        h.update(self.tokens_digest().encode())
        return h.hexdigest()

    def tokens_digest(self) -> str:
        """Cross-scale witness: generated token streams only (rid order).
        Identical across 1/2/4 devices AND all backends for one seed."""
        h = hashlib.sha256()
        for s in self.stats:
            h.update(f"{s.rid}:{','.join(map(str, s.tokens))}\n".encode())
        return h.hexdigest()
