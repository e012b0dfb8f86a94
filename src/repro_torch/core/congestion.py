"""Memory-congestion emulation: shared-link contention model (paper §IV-C).

The paper randomizes AXI handshake signals to stress protocol handling.  The
software adaptation pushes a transaction stream through a parameterized
shared-link model with seeded random denial-of-service: engines contend for
interconnect bandwidth, acquire stalls, and the resulting per-engine stall
statistics are the Fig. 8 "memory stalls" series.  Deterministic under a
seed, so congestion regressions are testable.

Two entry points share one arbitration core:

* ``LinkModel`` — the *online* model.  A ``MemoryBridge`` constructed with a
  ``CongestionConfig`` owns one and routes every device access and burst
  list through it as the firmware runs, so ``bridge.time``, per-engine
  stalls, and makespan reflect Fig. 8 semantics live, with no post-hoc
  replay step.
* ``simulate`` — the *offline* replay.  Feeds a complete recorded stream
  through a fresh ``LinkModel`` in one batch; used for what-if re-runs of a
  logged stream under a different link configuration.

Feeding a stream to ``simulate`` and submitting the same stream as a single
``LinkModel.submit`` batch produce identical timing — they are the same
loop (see tests/test_core_bridge.py::test_online_matches_offline_replay).

Arbitration is vectorized (docs/performance.md): grant order is computed
in closed form per round-robin phase, DoS draws and transfer latencies in
one numpy pass per batch, and only the serial timing recurrence remains a
(lean) Python loop — bit-identical to the retained ``_submit_scalar``
reference, witnessed by the differential tier (tests/test_simspeed.py).
"""
from __future__ import annotations

import copy
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.transactions import BurstBatch, Transaction, TransactionLog


@dataclasses.dataclass(frozen=True)
class CongestionConfig:
    """Shared-interconnect parameters (paper §IV-C / Fig. 8).

    ``priorities`` reproduces the paper's "input DMA was given higher
    priority" experiment: higher values win arbitration when contending;
    ties fall back to round-robin.  ``dos_prob``/``dos_stall`` are the
    seeded denial-of-service injection (the AXI-handshake randomization
    analogue).  ``max_burst_bytes`` splits whole-buffer device transfers
    into link-level bursts so a large ``dev_read`` contends at burst
    granularity rather than monopolizing the link in one transaction.
    """
    link_bytes_per_cycle: float = 128.0     # shared interconnect width
    base_latency: float = 40.0              # cycles per burst (DDR-ish)
    dos_prob: float = 0.0                   # P(denial-of-service per tx)
    dos_stall: float = 200.0                # cycles withheld on DoS
    per_engine_issue_gap: float = 1.0       # min cycles between issues
    seed: int = 0
    # interconnect arbitration priority per engine (higher wins when
    # contending; ties round-robin) — the paper's "input DMA was given
    # higher priority" experiment (Fig. 8).
    priorities: tuple = ()                  # of (engine, prio) pairs
    # split device transfers into bursts of at most this many bytes when
    # routed through the online link (0 = never split).
    max_burst_bytes: int = 4096

    def perturbed(self, rng: "np.random.Generator") -> "CongestionConfig":
        """Seeded jitter of the link parameters — the fault plan's
        ``congestion_perturb`` kind (core/fuzz.py).

        Bandwidth/latency scale by [0.5, 2.0), DoS probability jitters
        upward, burst granularity halves or doubles, and the DoS seed is
        re-drawn.  Timing-only: functional DDR contents are unaffected, so
        backend equivalence must survive any perturbation.
        """
        return dataclasses.replace(
            self,
            link_bytes_per_cycle=max(
                1.0, self.link_bytes_per_cycle * float(rng.uniform(0.5, 2.0))),
            base_latency=self.base_latency * float(rng.uniform(0.5, 2.0)),
            dos_prob=float(np.clip(self.dos_prob + rng.uniform(0.0, 0.2),
                                   0.0, 0.9)),
            per_engine_issue_gap=self.per_engine_issue_gap
            * float(rng.uniform(0.5, 2.0)),
            max_burst_bytes=max(256, int(self.max_burst_bytes
                                         * float(rng.choice([0.5, 1.0, 2.0])))),
            seed=int(rng.integers(0, 2 ** 31)),
        )


@dataclasses.dataclass
class CongestionResult:
    """Per-run link statistics — the Fig. 8 stall/utilization series."""
    makespan: float
    per_engine_stall: Dict[str, float]
    per_engine_busy: Dict[str, float]
    link_utilization: float
    timeline: List[Transaction]

    def summary(self) -> dict:
        return {
            "makespan": self.makespan,
            "link_utilization": round(self.link_utilization, 4),
            "stalls": {k: round(v, 1) for k, v in
                       sorted(self.per_engine_stall.items())},
        }


class LinkModel:
    """Stateful shared-link arbiter — the online congestion model (§IV-C).

    One instance models one interconnect.  ``submit`` arbitrates a batch of
    transactions (a kernel burst list, or a single device access) against
    the link state left by every earlier batch: per-engine ready times, the
    link-free horizon, the round-robin pointer, and the seeded DoS stream
    all persist across submissions, so firmware-program-order contention is
    modeled exactly as it happens.

    Within a batch, arbitration is priority-then-round-robin per engine,
    identical to the paper's interconnect arbiter; per-engine program order
    is always preserved.  Mutates each transaction's ``stall``/``complete``
    fields in place.

    Three submission paths, one arbitration semantics:

    * ``_submit_scalar`` — the original per-burst Python loop, retained
      verbatim as the differential reference (tests/test_simspeed.py).
    * ``submit`` — the vectorized object path over ``List[Transaction]``.
    * ``submit_batch`` — the array path over a ``BurstBatch``; appends the
      arbitrated batch as a lazy segment to the timeline and the log.
    """

    def __init__(self, cfg: CongestionConfig) -> None:
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._prio = dict(cfg.priorities)
        self._link_free = 0.0
        self._ready: Dict[str, float] = defaultdict(float)
        self._busy: Dict[str, float] = defaultdict(float)
        self._stall: Dict[str, float] = defaultdict(float)
        self._total_bytes = 0
        # running DoS total, folded per grant in grant order — the same
        # float sequence the profiler folds per channel, so the counter
        # layer's dos_cycles is bit-exact against stall attribution
        self._dos_total = 0.0
        self._rr = 0
        self._timeline: List[Transaction] = []
        self._tl_pending: List[BurstBatch] = []

    @property
    def now(self) -> float:
        """Link-free horizon: completion time of the last transfer."""
        return self._link_free

    @property
    def timeline(self) -> List[Transaction]:
        """Arbitration-order transaction timeline.  Batch-submitted
        segments materialize on first read (profiler/result paths); the
        hot path appends lazily."""
        if self._tl_pending:
            for b in self._tl_pending:
                self._timeline.extend(b.materialize())
            self._tl_pending.clear()
        return self._timeline

    # ------------------------------------------------------- scalar reference
    def _submit_scalar(self, txs: List[Transaction],
                       log: Optional[TransactionLog] = None) -> float:
        """The original per-burst arbitration loop, retained verbatim as
        the bit-exactness reference for the vectorized paths.  Semantics
        documentation lives here: ``submit``/``submit_batch`` must match
        this loop's output (and RNG/rr side effects) exactly."""
        cfg = self.cfg
        queues: Dict[str, List[Transaction]] = defaultdict(list)
        for t in txs:
            queues[t.engine].append(t)
        heads = {e: 0 for e in queues}
        engines = sorted(queues, key=lambda e: (-self._prio.get(e, 0), e))
        last = self._link_free
        while any(heads[e] < len(queues[e]) for e in engines):
            # highest-priority engine with pending work; ties round-robin
            pending = [e for e in engines if heads[e] < len(queues[e])]
            top = max(self._prio.get(e, 0) for e in pending)
            cand = [e for e in pending if self._prio.get(e, 0) == top]
            e = cand[self._rr % len(cand)]
            self._rr += 1
            tx = queues[e][heads[e]]
            heads[e] += 1
            issue = max(self._ready[e], tx.time)
            start = max(issue, self._link_free)
            wait = start - issue
            dos = 0.0
            if cfg.dos_prob > 0 and self._rng.random() < cfg.dos_prob:
                dos = cfg.dos_stall
            xfer = cfg.base_latency + tx.nbytes / cfg.link_bytes_per_cycle
            tx.stall = wait + dos
            tx.dos = dos            # DoS component, for stall attribution
            tx.complete = start + dos + xfer
            self._link_free = tx.complete
            self._ready[e] = tx.complete + cfg.per_engine_issue_gap
            self._busy[e] += xfer
            self._stall[e] += tx.stall
            self._dos_total += dos
            self._total_bytes += tx.nbytes
            self.timeline.append(tx)
            last = tx.complete
            if log is not None:
                log.log(tx)
        return last

    # ------------------------------------------------------ vectorized core
    def _grant_order(self, n: int,
                     by_eng: Dict[str, List[int]]) -> Optional[np.ndarray]:
        """Grant order for one batch as source indices, advancing the
        round-robin pointer exactly as the scalar loop does.

        Grant order is timing-independent (priority, round-robin pointer,
        and per-engine queue lengths fully determine it), so it can be
        computed in closed form: within a candidate set of size ``k`` at
        round-robin phase ``r``, the engine at position ``p`` is granted
        at steps ``(p - r) % k, +k, +2k, ...`` until the first engine
        empties, which ends the phase.  Returns None for the single-engine
        fast path (grant order = program order; note the scalar loop still
        advances ``_rr`` once per grant even then)."""
        prio = self._prio
        if len(by_eng) == 1:
            self._rr += n
            return None
        engines = sorted(by_eng, key=lambda e: (-prio.get(e, 0), e))
        order = np.empty(n, dtype=np.int64)
        base = 0
        rr = self._rr
        gi = 0
        while gi < len(engines):
            # one priority group at a time, strictly descending
            p0 = prio.get(engines[gi], 0)
            gj = gi
            while gj < len(engines) and prio.get(engines[gj], 0) == p0:
                gj += 1
            group = engines[gi:gj]
            gi = gj
            rem = [len(by_eng[e]) for e in group]
            cons = [0] * len(group)
            cand = list(range(len(group)))
            while cand:
                k = len(cand)
                r = rr % k
                # phase length: steps until the first candidate empties
                best = None
                for pos, ci in enumerate(cand):
                    s_p = (pos - r) % k
                    end = s_p + (rem[ci] - 1) * k
                    if best is None or end < best:
                        best = end
                L = best + 1
                nxt = []
                for pos, ci in enumerate(cand):
                    s_p = (pos - r) % k
                    g = 0 if L <= s_p else (L - 1 - s_p) // k + 1
                    if g:
                        ids = by_eng[group[ci]]
                        order[base + s_p: base + s_p + g * k: k] = \
                            ids[cons[ci]:cons[ci] + g]
                        cons[ci] += g
                        rem[ci] -= g
                    if rem[ci]:
                        nxt.append(ci)
                base += L
                rr += L
                cand = nxt
        self._rr = rr
        return order

    def _dos_draws(self, n: int) -> Optional[List[float]]:
        """One DoS draw per grant, in grant order — ``Generator.random(n)``
        consumes the bit stream identically to n scalar ``random()`` calls,
        so the RNG state matches the scalar loop after every batch."""
        cfg = self.cfg
        if cfg.dos_prob <= 0:
            return None
        hits = self._rng.random(n) < cfg.dos_prob
        if not hits.any():
            return None     # all-zero stalls: callers may skip the column
        return np.where(hits, cfg.dos_stall, 0.0).tolist()

    def submit(self, txs: List[Transaction],
               log: Optional[TransactionLog] = None) -> float:
        """Arbitrate one batch of transactions through the shared link.

        Transactions must be in per-engine program order; ``time`` fields
        are minimum issue times (0 = ASAP).  Returns the completion time of
        the last transaction in the batch.

        Vectorized object path: grant order + DoS draws + transfer
        latencies are computed per batch; the serial timing recurrence
        (each burst's start depends on the previous completion) runs over
        plain floats in the exact scalar FP-operation order, so results
        are bit-identical to ``_submit_scalar``.
        """
        cfg = self.cfg
        n = len(txs)
        if n == 0:
            return self._link_free
        by_eng: Dict[str, List[int]] = {}
        for i, t in enumerate(txs):
            e = t.engine
            if e in by_eng:
                by_eng[e].append(i)
            else:
                by_eng[e] = [i]
        order = self._grant_order(n, by_eng)
        granted = list(txs) if order is None \
            else [txs[i] for i in order.tolist()]
        dos_l = self._dos_draws(n) or [0.0] * n
        xfer_l = (cfg.base_latency +
                  np.array([t.nbytes for t in granted], dtype=np.float64)
                  / cfg.link_bytes_per_cycle).tolist()
        link_free = self._link_free
        gap = cfg.per_engine_issue_gap
        ready, busy, stall_acc = self._ready, self._busy, self._stall
        dos_total = self._dos_total
        total = 0
        for i, tx in enumerate(granted):
            e = tx.engine
            r = ready[e]
            t = tx.time
            issue = r if r >= t else t
            start = issue if issue >= link_free else link_free
            d = dos_l[i]
            x = xfer_l[i]
            st = (start - issue) + d
            comp = start + d + x
            tx.stall = st
            tx.dos = d
            tx.complete = comp
            link_free = comp
            ready[e] = comp + gap
            busy[e] += x
            stall_acc[e] += st
            dos_total += d
            total += tx.nbytes
        self._link_free = link_free
        self._dos_total = dos_total
        self._total_bytes += total
        self.timeline.extend(granted)
        if log is not None:
            log.extend(granted)
        return link_free

    def submit_batch(self, batch: BurstBatch,
                     log: Optional[TransactionLog] = None) -> float:
        """Array path: arbitrate one ``BurstBatch`` through the link.

        Same semantics as ``submit`` but end-to-end over columns — the
        batch is permuted into grant order in place, the recurrence runs
        over plain floats pulled from the columns, results are written
        back per column, and the batch is appended as a *lazy* segment to
        the timeline and ``log`` (shared, so materialized Transaction
        objects alias between the two exactly as object submission does).
        Returns the completion time of the last burst.
        """
        cfg = self.cfg
        n = len(batch)
        if n == 0:
            return self._link_free
        eng = batch.engine
        if len(set(eng)) == 1:
            # single-engine fast path — same rr bookkeeping as the scalar
            # loop (one advance per grant) without the index-map build
            self._rr += n
        else:
            by_eng: Dict[str, List[int]] = {}
            for i, e in enumerate(eng):
                if e in by_eng:
                    by_eng[e].append(i)
                else:
                    by_eng[e] = [i]
            order = self._grant_order(n, by_eng)
            if order is not None:
                batch.permute(order)
                eng = batch.engine
        rec = batch.rec
        dos_l = self._dos_draws(n)
        # transfer latency over plain floats: same IEEE ops per element as
        # the numpy column expression, cheaper at real batch sizes
        lbpc = cfg.link_bytes_per_cycle
        bl = cfg.base_latency
        nb_l = rec["nbytes"].tolist()
        xfer_l = [bl + nb / lbpc for nb in nb_l]
        times_l = rec["time"].tolist()
        link_free = self._link_free
        gap = cfg.per_engine_issue_gap
        ready, busy, stall_acc = self._ready, self._busy, self._stall
        stall_l = [0.0] * n
        comp_l = [0.0] * n
        if dos_l is None:
            for i in range(n):
                e = eng[i]
                r = ready[e]
                t = times_l[i]
                issue = r if r >= t else t
                start = issue if issue >= link_free else link_free
                x = xfer_l[i]
                st = start - issue
                comp = start + x
                stall_l[i] = st
                comp_l[i] = comp
                link_free = comp
                ready[e] = comp + gap
                busy[e] += x
                stall_acc[e] += st
        else:
            dos_total = self._dos_total
            for i in range(n):
                e = eng[i]
                r = ready[e]
                t = times_l[i]
                issue = r if r >= t else t
                start = issue if issue >= link_free else link_free
                d = dos_l[i]
                x = xfer_l[i]
                st = (start - issue) + d
                comp = start + d + x
                stall_l[i] = st
                comp_l[i] = comp
                link_free = comp
                ready[e] = comp + gap
                busy[e] += x
                stall_acc[e] += st
                dos_total += d
            # the no-DoS branch skips the fold: x + 0.0 == x bitwise, so
            # the accumulated value is identical to the scalar reference
            self._dos_total = dos_total
            rec["dos"] = dos_l
        rec["stall"] = stall_l
        rec["complete"] = comp_l
        self._link_free = link_free
        self._total_bytes += sum(nb_l)
        # lazy append: ordering vs already-materialized entries is safe
        # because every object-path extend goes through the flushing
        # ``timeline`` property first
        self._tl_pending.append(batch)
        if log is not None:
            log.log_batch(batch)
        return link_free

    # ------------------------------------------------------ counter probes
    # Read-only accessors for the always-on counter layer
    # (core/counters.py).  The per-engine folds are summed in sorted-
    # engine order so the probe is deterministic and, each term being a
    # non-decreasing non-negative fold, monotone across samples.
    def counter_bytes(self) -> int:
        return self._total_bytes

    def counter_busy(self) -> float:
        busy = self._busy
        t = 0.0
        for e in sorted(busy):
            t += busy[e]
        return t

    def counter_stall(self) -> float:
        stall = self._stall
        t = 0.0
        for e in sorted(stall):
            t += stall[e]
        return t

    def counter_dos(self) -> float:
        return self._dos_total

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> dict:
        """Snapshot of the arbiter for a replay checkpoint
        (core/replay.py): RNG stream position, link-free horizon,
        per-engine ready/busy/stall, the round-robin pointer, and the
        timeline (so ``result()`` stays correct after a restore).  A
        restored link arbitrates future batches bit-identically to the
        original run.  Timeline entries are shared, not copied — a
        transaction is mutated only before arbitration, so the logged
        prefix is immutable and checkpointing stays O(n) per snapshot."""
        return {
            "rng": copy.deepcopy(self._rng.bit_generator.state),
            "link_free": self._link_free,
            "ready": dict(self._ready),
            "busy": dict(self._busy),
            "stall": dict(self._stall),
            "total_bytes": self._total_bytes,
            "dos_total": self._dos_total,
            "rr": self._rr,
            "timeline": list(self.timeline),
        }

    def set_state(self, state: dict) -> None:
        self._rng.bit_generator.state = copy.deepcopy(state["rng"])
        self._link_free = state["link_free"]
        self._ready = defaultdict(float, state["ready"])
        self._busy = defaultdict(float, state["busy"])
        self._stall = defaultdict(float, state["stall"])
        self._total_bytes = state["total_bytes"]
        self._dos_total = state.get("dos_total", 0.0)
        self._rr = state["rr"]
        # restored entries are aliased, not re-copied: transactions are
        # immutable once arbitrated (mutation happens pre-submit), and the
        # restore path is the replay hot loop
        self._tl_pending.clear()
        self._timeline[:] = state["timeline"]

    def result(self) -> CongestionResult:
        """Snapshot the Fig. 8 statistics accumulated so far."""
        makespan = max((t.complete for t in self.timeline), default=0.0)
        util = ((self._total_bytes / self.cfg.link_bytes_per_cycle)
                / makespan if makespan else 0.0)
        return CongestionResult(
            makespan=makespan,
            per_engine_stall=dict(self._stall),
            per_engine_busy=dict(self._busy),
            link_utilization=util,
            timeline=list(self.timeline),
        )


def simulate(txs: List[Transaction], cfg: CongestionConfig,
             log: Optional[TransactionLog] = None) -> CongestionResult:
    """Offline replay (§IV-C): a recorded stream through a fresh link.

    Transactions must be in per-engine program order; ``time`` fields are
    used as minimum issue times (0 = ASAP).  Mutates tx.stall/tx.complete.
    Identical timing to submitting the same stream as one ``LinkModel``
    batch — both run the same arbitration core.
    """
    lm = LinkModel(cfg)
    lm.submit(txs, log)
    return lm.result()


def collective_stream_to_txs(collectives, time_scale: float = 1.0
                             ) -> List[Transaction]:
    """Adapt an hlo_profiler collective stream into congestion-model
    transactions (engine = collective kind): stress-replays the compiled
    program's communication schedule under contention."""
    txs = []
    t = 0.0
    for c in collectives:
        for r in range(min(c.multiplier, 1000)):    # cap replay length
            txs.append(Transaction(t, c.kind, "read", 0, c.bytes_moved))
            t += time_scale
    return txs
