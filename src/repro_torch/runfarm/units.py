"""Campaign work units — the sharding quantum of the run farm.

A unit is a **seed-closed job**: everything it needs is in ``(kind, seed,
params)``, all JSON-round-trippable, so the same unit executes identically
in the manager process, in a spawned worker, or on a remote host tomorrow.
Unit seeds derive from the campaign seed by the same construction as
``FaultPlan.fork`` (sha256 over ``"{seed}/{label}"``), so the stimulus a
unit generates depends only on its uid — never on which worker ran it,
in what order, or how many peers it had.

Uids are ``g<generation>/u<index>`` and sort lexicographically in
execution order; the campaign's final digest hashes ``(uid, digest)``
pairs in uid order, which is what makes the merged result independent of
worker count (the determinism bar in docs/runfarm.md).

The device a unit runs on is not part of the unit: it travels beside it
(``execute_unit(unit, device)``, ``worker_main(..., device)``), so a
unit's JSON and payload hash are the same whichever card or CPU runs it,
and equal to the JAX package's for the same builder call.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence


def fork_seed(seed: int, label: str) -> int:
    """Deterministic child seed — identical construction to
    ``FaultPlan.fork`` (core/fuzz.py), so unit seeds are order- and
    process-independent."""
    return int.from_bytes(
        hashlib.sha256(f"{seed}/{label}".encode()).digest()[:8], "little")


def unit_uid(gen: int, index: int) -> str:
    return f"g{gen:02d}/u{index:05d}"


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One schedulable job: executed by ``runfarm.builtin.execute_unit``
    under the executor registered for ``kind``."""
    uid: str
    kind: str              # executor: fuzz_batch | sweep | golden | serving
    seed: int
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    parent: Optional[str] = None        # uid of the mutation parent, if any

    def payload_hash(self) -> str:
        """Identity of the unit's *inputs*; stored with its result record
        so a resumed campaign detects spec drift (same uid, different
        job) and re-runs instead of silently reusing a stale record."""
        blob = json.dumps({"kind": self.kind, "seed": self.seed,
                           "params": self.params, "parent": self.parent},
                          sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {"uid": self.uid, "kind": self.kind, "seed": self.seed,
                "params": self.params, "parent": self.parent}

    @classmethod
    def from_json(cls, d: dict) -> "WorkUnit":
        return cls(uid=d["uid"], kind=d["kind"], seed=int(d["seed"]),
                   params=dict(d.get("params") or {}),
                   parent=d.get("parent"))


@dataclasses.dataclass
class UnitResult:
    """One executed unit's outcome, as shipped over the result queue and
    persisted (via ``record()``) to the JSONL store.  ``seconds`` is
    worker-side wall clock and is excluded from every digest — it is the
    only non-deterministic field."""
    uid: str
    kind: str
    ok: bool
    digest: str                         # deterministic per-unit witness
    counts: Dict[str, Dict[str, int]]   # sparse CoverageModel.to_counts()
    scenarios: int                      # work quantum for scenarios/sec
    seconds: float = 0.0
    failures: List[str] = dataclasses.field(default_factory=list)
    harvest: Optional[dict] = None      # shrunk repro / divergence bundle
    worker: int = -1
    # sampled performance-counter totals (core/counters.py), name ->
    # cumulative value summed over the unit's banks; merged fleet-wide in
    # uid order at the generation barrier, like coverage counts
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def record(self, payload_hash: str) -> dict:
        """The JSONL store record (one line, sort_keys canonical)."""
        rec = {"uid": self.uid, "kind": self.kind, "ok": self.ok,
               "digest": self.digest, "counts": self.counts,
               "scenarios": self.scenarios,
               "seconds": round(self.seconds, 6),
               "failures": self.failures, "payload": payload_hash,
               "worker": self.worker}
        if self.harvest is not None:
            rec["harvest"] = self.harvest
        if self.counters:
            rec["counters"] = {
                n: (round(v, 6) if isinstance(v, float) else v)
                for n, v in self.counters.items()}
        return rec


# ------------------------------------------------------- gen-0 builders
def fuzz_units(seed: int, n_scenarios: int, batch: int = 250,
               layers: Sequence[str] = ("registers",), gen: int = 0,
               start_index: int = 0, rates: Optional[Dict[str, float]] = None,
               bridge_ops: Optional[Sequence[int]] = None,
               mm_bug: Optional[Sequence[float]] = None,
               shrink_failures: bool = True) -> List[WorkUnit]:
    """Shard an ``n_scenarios`` ProtocolFuzzer campaign into batch units.

    Each unit fuzzes ``batch`` scenarios under its own forked fuzzer seed
    (scenario indices restart at 0 per unit — the seed, not the index,
    carries the entropy).  ``mm_bug=(i, j, delta)`` plants the known
    interpret-backend bug (core/fuzz.planted_bug_table) so harvesting has
    something to shrink."""
    params: Dict[str, Any] = {"layers": list(layers),
                              "shrink_failures": bool(shrink_failures)}
    if rates:
        params["rates"] = dict(rates)
    if bridge_ops is not None:
        params["bridge_ops"] = [int(bridge_ops[0]), int(bridge_ops[1])]
    if mm_bug is not None:
        params["mm_bug"] = [int(mm_bug[0]), int(mm_bug[1]),
                            float(mm_bug[2])]
    units = []
    i = 0
    while i * batch < n_scenarios:
        uid = unit_uid(gen, start_index + i)
        count = min(batch, n_scenarios - i * batch)
        units.append(WorkUnit(uid, "fuzz_batch", fork_seed(seed, uid),
                              params=dict(params, count=count)))
        i += 1
    return units


def sweep_units(seed: int, configs: Sequence[Dict[str, Any]],
                backends: Sequence[str] = ("oracle", "interpret"),
                gen: int = 0, start_index: int = 0,
                congestion_seed: int = 7,
                mm_bug: Optional[Sequence[float]] = None,
                configs_per_unit: int = 2) -> List[WorkUnit]:
    """Shard a CoVerifySession matmul sweep: each unit runs a slice of
    ``configs`` (every backend per config) as one in-process session with
    its own forked fault-plan seed."""
    units = []
    chunk = max(1, int(configs_per_unit))
    for i in range(0, len(configs), chunk):
        uid = unit_uid(gen, start_index + len(units))
        params: Dict[str, Any] = {
            "configs": [dict(c) for c in configs[i:i + chunk]],
            "backends": list(backends),
            "congestion_seed": int(congestion_seed)}
        if mm_bug is not None:
            params["mm_bug"] = [int(mm_bug[0]), int(mm_bug[1]),
                                float(mm_bug[2])]
        units.append(WorkUnit(uid, "sweep", fork_seed(seed, uid), params))
    return units


def golden_units(names: Sequence[str], gen: int = 0, start_index: int = 0
                 ) -> List[WorkUnit]:
    """One unit per golden trace: regenerate it and diff against the
    committed rendering (tests/golden/) — the farm's cheapest
    whole-stack integrity probe."""
    return [WorkUnit(unit_uid(gen, start_index + i), "golden", 0,
                     {"name": str(n)}) for i, n in enumerate(names)]


def serving_units(seed: int, traces: Sequence[Dict[str, Any]],
                  pools: Sequence[Dict[str, Any]] = (
                      {"kv_pages": 6, "kv_page_size": 8},),
                  devices: Sequence[int] = (1,), gen: int = 0,
                  start_index: int = 0,
                  max_ticks: int = 50_000) -> List[WorkUnit]:
    """Shard an open-loop serving SLO campaign: one unit per
    (arrival-trace spec x KV-pool geometry x device count).

    A trace spec is ``{"kind": "poisson"|"bursty", "params": {...}}``
    (serving/arrivals.ARRIVAL_KINDS); the trace SEED is the unit's own
    forked seed, so the arrival stimulus follows the uid and shards need
    no coordination — any worker regenerates the identical trace from the
    JSON params.  A pool spec may also override engine shape
    (``max_slots`` / ``max_len`` / ``prompt_pad``)."""
    units = []
    for t in traces:
        for pool in pools:
            for n in devices:
                uid = unit_uid(gen, start_index + len(units))
                params: Dict[str, Any] = {
                    "kind": str(t["kind"]),
                    "trace": dict(t.get("params") or {}),
                    "pool": dict(pool), "devices": int(n),
                    "max_ticks": int(max_ticks)}
                units.append(WorkUnit(uid, "serving",
                                      fork_seed(seed, uid), params))
    return units


def mutate_unit(parent: WorkUnit, j: int, uid: str) -> WorkUnit:
    """Default mutation: a child exploring near a productive seed — same
    stimulus shape (params copied), seed forked from the PARENT's seed, so
    the mutation lineage is itself deterministic and worker-independent."""
    return WorkUnit(uid, parent.kind, fork_seed(parent.seed, f"mut/{j}"),
                    params=dict(parent.params), parent=parent.uid)
