"""Functional-coverage model over co-verification stimulus (the paper's
"did the randomized testing actually exercise the protocol?" question,
turned into explicit coverage bins the way RTL verification closes
coverage before signoff).

Groups and bins are *declared up front* — a hit on an unknown bin raises,
so the bin set cannot silently drift from the stimulus generators:

  protocol    — register-protocol events (doorbell-while-busy, W1C clear
                edges, RO writes, unmapped accesses, poll outcomes)
  burst_size  — transaction-size buckets (CSR words up to >4K DMA bursts)
  congestion  — link arbitration states seen by transactions
  fault_kind  — injected bridge-fault taxonomy (mirrors
                fuzz.DEFAULT_RATES; tests/test_torch_coverage.py pins
                the two sets together)
  fabric      — multi-device interconnect operations (core/fabric.py)
  serving     — serving-submit protocol outcomes (fuzz serving layer)
  arrivals    — open-loop arrival/admission outcomes (serving/arrivals.py
                process shapes + KV-pool admission-control events)
  topology    — interconnect shape a fabric run routed through
                (crossbar default or a core/topology.py builder)
  hops        — switch-hop count per routed journey (h0 = endpoints on
                one switch, h3plus = deep routes)
  credit_stall— credit-based flow control outcomes at switch ports
                (granted immediately vs. waited for a credit)

``ProtocolFuzzer`` feeds it while scenarios run and ``FabricCluster``
feeds it from fabric transfers; the fuzz acceptance run must reach 100%
of the protocol bins, and ``report()`` names any hole.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

PROTOCOL_BINS = ("doorbell_ok", "doorbell_busy", "ro_write", "w1c_clear",
                 "illegal_read", "illegal_write", "poll_ok", "poll_timeout")
# (bin name, inclusive upper bound in bytes); None = unbounded
BURST_BUCKETS: Tuple[Tuple[str, Optional[int]], ...] = (
    ("le_64B", 64), ("le_1KB", 1024), ("le_4KB", 4096), ("gt_4KB", None))
CONGESTION_BINS = ("free", "stalled")
FAULT_BINS = ("dma_delay", "dma_reorder", "dma_split", "bitflip_read",
              "congestion_perturb")
FABRIC_BINS = ("dev_copy", "scatter", "broadcast", "gather", "all_reduce")
SERVING_BINS = ("ok", "bad_len", "zero_maxnew", "dup_rid", "over_budget",
                "max_maxnew", "pad_straddle")
# open-loop arrival-process outcomes (serving/arrivals.py): which process
# shapes ran, whether admission control ever deferred, whether the pool
# saturated, and whether a doorbell-time infeasible request was rejected
ARRIVALS_BINS = ("poisson", "bursty", "replay", "deferred", "pool_full",
                 "infeasible_reject")
# crossbar plus core/topology.py's TOPOLOGY_KINDS (tests pin the two sets)
TOPOLOGY_BINS = ("crossbar", "ring", "torus2d", "fat_tree")
HOP_BINS = ("h0", "h1", "h2", "h3plus")
CREDIT_BINS = ("granted", "waited")

GROUPS: Dict[str, Tuple[str, ...]] = {
    "protocol": PROTOCOL_BINS,
    "burst_size": tuple(name for name, _ in BURST_BUCKETS),
    "congestion": CONGESTION_BINS,
    "fault_kind": FAULT_BINS,
    "fabric": FABRIC_BINS,
    "serving": SERVING_BINS,
    "arrivals": ARRIVALS_BINS,
    "topology": TOPOLOGY_BINS,
    "hops": HOP_BINS,
    "credit_stall": CREDIT_BINS,
}


class CoverageModel:
    """Hit counters over the declared coverage groups.

    ``hit()`` is thread-safe: one model may be shared as the sink of
    concurrent sweep cells / fuzz scenarios on a thread pool
    (``CoVerifySession.run``), where the unguarded ``counts[g][b] += n``
    read-modify-write used to lose updates between the load and the
    store.  The lock is intentionally per-model and held only for the
    increment; cross-process campaigns (the run farm) instead give every
    worker a private model and ``merge()`` them deterministically."""

    def __init__(self) -> None:
        self.counts: Dict[str, Dict[str, int]] = {
            g: {b: 0 for b in bins} for g, bins in GROUPS.items()}
        self._lock = threading.Lock()

    # locks are not picklable; a model shipped across processes (runfarm
    # result records) re-grows a fresh one on arrival
    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- feeding
    def hit(self, group: str, bin_name: str, n: int = 1) -> None:
        """Record ``n`` hits; unknown group/bin raises (drift guard)."""
        bins = self.counts.get(group)
        if bins is None:
            raise KeyError(f"unknown coverage group {group!r}")
        if bin_name not in bins:
            raise KeyError(
                f"unknown bin {bin_name!r} in group {group!r} "
                f"(declared: {sorted(bins)})")
        with self._lock:
            bins[bin_name] += n

    def hit_burst(self, nbytes: int) -> None:
        """Bucket one transaction by burst size."""
        for name, bound in BURST_BUCKETS:
            if bound is None or nbytes <= bound:
                self.hit("burst_size", name)
                return

    def hit_congestion(self, stall: float) -> None:
        """Bucket one arbitrated transaction by its congestion outcome."""
        self.hit("congestion", "stalled" if stall > 0 else "free")

    def hit_hops(self, n_hops: int) -> None:
        """Bucket one routed journey by its switch-hop count."""
        self.hit("hops", f"h{n_hops}" if n_hops < 3 else "h3plus")

    def merge(self, other: "CoverageModel") -> "CoverageModel":
        for g, bins in other.counts.items():
            for b, n in bins.items():
                if n:
                    self.hit(g, b, n)
        return self

    # --------------------------------------------------- (de)serialization
    def to_counts(self) -> Dict[str, Dict[str, int]]:
        """Sparse JSON-friendly snapshot: only nonzero bins, for the
        runfarm's per-unit result records (one line of JSON per unit)."""
        with self._lock:
            return {g: {b: n for b, n in bins.items() if n}
                    for g, bins in self.counts.items()
                    if any(bins.values())}

    @classmethod
    def from_counts(cls, counts: Dict[str, Dict[str, int]]
                    ) -> "CoverageModel":
        model = cls()
        for g, bins in counts.items():
            for b, n in bins.items():
                model.hit(g, b, int(n))
        return model

    def merge_counts(self, counts: Dict[str, Dict[str, int]]) -> List[str]:
        """Merge a sparse snapshot; returns the ``group.bin`` names this
        merge newly covered (count 0 -> >0) — the signal the runfarm's
        coverage-guided scheduler prioritizes seeds by."""
        new: List[str] = []
        for g in sorted(counts):
            for b in sorted(counts[g]):
                n = int(counts[g][b])
                if n:
                    if self.counts[g][b] == 0:
                        new.append(f"{g}.{b}")
                    self.hit(g, b, n)
        return new

    # ------------------------------------------------------------- queries
    def percent(self, group: str) -> float:
        bins = self.counts[group]
        return 100.0 * sum(1 for n in bins.values() if n) / len(bins)

    def covered(self, group: str) -> bool:
        return all(n > 0 for n in self.counts[group].values())

    def holes(self, group: Optional[str] = None) -> List[str]:
        """Uncovered bins as ``group.bin`` names (all groups by default)."""
        groups = [group] if group is not None else sorted(self.counts)
        return [f"{g}.{b}" for g in groups
                for b, n in self.counts[g].items() if n == 0]

    def summary(self) -> Dict[str, dict]:
        return {g: {"percent": round(self.percent(g), 1),
                    "hits": sum(bins.values()),
                    "holes": self.holes(g)}
                for g, bins in self.counts.items()}

    def report(self, groups: Optional[List[str]] = None) -> str:
        """Human-readable coverage table; every hole is named explicitly
        (an unexercised bin that hides is a bin that never closes)."""
        names = groups if groups is not None else sorted(self.counts)
        lines = ["coverage (group: covered/total = percent [hits])"]
        all_holes: List[str] = []
        for g in names:
            bins = self.counts[g]
            cov = sum(1 for n in bins.values() if n)
            lines.append(f"  {g:12s} {cov}/{len(bins)} = "
                         f"{self.percent(g):5.1f}%  "
                         f"[{sum(bins.values())} hits]")
            all_holes += self.holes(g)
        if all_holes:
            lines.append("  UNCOVERED: " + ", ".join(all_holes))
        else:
            lines.append("  no uncovered bins")
        return "\n".join(lines)
