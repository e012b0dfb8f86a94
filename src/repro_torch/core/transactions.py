"""Transaction records + profiling (paper Figs. 8 and 9).

A Transaction is one logical memory burst: a DMA tile fetch (kernel
tile-schedule-derived), a register access, or a host<->device transfer.  The
TransactionLog renders bandwidth-utilization timelines and address/time
heatmaps — this port's analogue of FireBridge's AXI monitors.

The modeled-time hot path is batched (docs/performance.md): burst
splitting, fault perturbation, and link arbitration operate on
``BurstBatch`` column arrays, and the log holds arbitrated batches as
lazy segments — ``Transaction`` objects materialize only when something
actually reads ``txs``, and canonical lines / digests render straight
from the columns.  Everything stays bit-identical to the per-object
path; the differential tier (tests/test_simspeed.py) is the witness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Transaction:
    time: float                 # issue time (cycles or seconds — caller's unit)
    engine: str                 # "dma_a", "host", "csr", ...
    kind: str                   # "read" | "write"
    addr: int
    nbytes: int
    tag: str = ""
    stall: float = 0.0          # stall time injected by the congestion model
    complete: float = 0.0       # completion time (filled by congestion model)
    # profiling attribution (core/profiler.py): the DoS component of
    # ``stall`` (filled by the congestion arbiter) and the min-issue delay
    # added by an injected dma_delay fault (filled by the fault plan).
    # Never rendered into canonical lines — golden traces are unaffected.
    dos: float = 0.0
    fault_delay: float = 0.0


# Column layout of one burst batch: every numeric Transaction field,
# including the profiling-attribution columns, so per-tx attribution
# survives vectorization unchanged.
BURST_DTYPE = np.dtype([
    ("time", np.float64), ("addr", np.int64), ("nbytes", np.int64),
    ("stall", np.float64), ("complete", np.float64),
    ("dos", np.float64), ("fault_delay", np.float64),
])


class BurstBatch:
    """One batch of link-level bursts as a structured array + string
    columns — the unit the vectorized hot path moves around instead of
    ``List[Transaction]``.

    ``rec`` is a structured numpy array (``BURST_DTYPE``); ``engine``,
    ``kind`` and ``tag`` are parallel Python lists (string columns in
    structured arrays cost more than they save at these batch sizes).

    Lifecycle contract: build (split) -> perturb (fault plan) ->
    arbitrate (stall/complete/dos filled in grant order) -> logged.
    Once logged a batch is immutable — the same invariant a logged
    ``Transaction`` already has — so ``materialize()`` may cache, and
    the log and the link timeline sharing one segment alias the same
    Transaction objects, exactly like per-object submission.
    """

    __slots__ = ("rec", "engine", "kind", "tag", "_txs")

    def __init__(self, rec: np.ndarray, engine: List[str], kind: List[str],
                 tag: List[str]) -> None:
        self.rec = rec
        self.engine = engine
        self.kind = kind
        self.tag = tag
        self._txs: Optional[List[Transaction]] = None

    def __len__(self) -> int:
        return len(self.engine)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_transfer(cls, time: float, engine: str, kind: str, addr: int,
                      nbytes: int, tag: str, step: int) -> "BurstBatch":
        """``split_bursts`` over columns: one transfer -> its burst batch
        (at most ``step`` bytes per burst; 0 = never split)."""
        return cls.from_runs(time, engine, kind, [(addr, nbytes)], tag, step)

    @classmethod
    def from_runs(cls, time: float, engine: str, kind: str,
                  runs: Sequence[Tuple[int, int]], tag: str,
                  step: int) -> "BurstBatch":
        """One transfer leg over byte ``runs`` (strided inner-axis shards),
        each run burst-split like ``split_bursts``."""
        addrs: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for a, nb in runs:
            if step <= 0 or nb <= step:
                addrs.append(np.array([a], dtype=np.int64))
                lens.append(np.array([nb], dtype=np.int64))
            else:
                off = np.arange(0, nb, step, dtype=np.int64)
                addrs.append(a + off)
                lens.append(np.minimum(step, nb - off))
        a_col = addrs[0] if len(addrs) == 1 else np.concatenate(addrs)
        n_col = lens[0] if len(lens) == 1 else np.concatenate(lens)
        n = len(a_col)
        rec = np.zeros(n, dtype=BURST_DTYPE)
        rec["time"] = time
        rec["addr"] = a_col
        rec["nbytes"] = n_col
        return cls(rec, [engine] * n, [kind] * n, [tag] * n)

    @classmethod
    def from_tuples(cls, time: float,
                    txs: Sequence[Tuple[str, str, int, int]]) -> "BurstBatch":
        """A kernel's static burst list — (engine, kind, addr, nbytes)
        tuples sharing one min-issue time (bridge.log_burst_list)."""
        n = len(txs)
        rec = np.zeros(n, dtype=BURST_DTYPE)
        rec["time"] = time
        if n:
            rec["addr"] = [t[2] for t in txs]
            rec["nbytes"] = [t[3] for t in txs]
        return cls(rec, [t[0] for t in txs], [t[1] for t in txs], [""] * n)

    # ------------------------------------------- fault-plan mutation hooks
    def permute(self, perm: np.ndarray) -> None:
        """Reorder the batch (dma_reorder fault) — pre-arbitration only."""
        self.rec = self.rec[perm]
        ol = perm.tolist()
        self.engine = [self.engine[i] for i in ol]
        self.kind = [self.kind[i] for i in ol]
        self.tag = [self.tag[i] for i in ol]

    def split_row(self, i: int) -> None:
        """Split burst ``i`` into two half-bursts (dma_split fault).
        The halves are fresh rows (zero stall/complete/dos/fault_delay),
        matching the scalar path's freshly constructed Transactions."""
        r = self.rec
        nb = int(r["nbytes"][i])
        half = nb // 2
        rows = np.zeros(2, dtype=BURST_DTYPE)
        rows["time"] = r["time"][i]
        rows["addr"] = (int(r["addr"][i]), int(r["addr"][i]) + half)
        rows["nbytes"] = (half, nb - half)
        self.rec = np.concatenate([r[:i], rows, r[i + 1:]])
        self.engine[i:i + 1] = [self.engine[i]] * 2
        self.kind[i:i + 1] = [self.kind[i]] * 2
        self.tag[i:i + 1] = [self.tag[i]] * 2

    def delay(self, delay: float) -> None:
        """Bump every burst's min-issue time (dma_delay fault), keeping
        the stall-attribution bookkeeping column in sync."""
        self.rec["time"] += delay
        self.rec["fault_delay"] += delay

    # ------------------------------------------------------ materialization
    def materialize(self) -> List[Transaction]:
        """Transaction objects for this batch — built once, cached, so
        every reader (log, link timeline, profiler) aliases the same
        objects, exactly as per-object submission would."""
        if self._txs is None:
            r = self.rec
            self._txs = [
                Transaction(t, e, k, a, nb, tag, st, c, d, fd)
                for t, a, nb, st, c, d, fd, e, k, tag in zip(
                    r["time"].tolist(), r["addr"].tolist(),
                    r["nbytes"].tolist(), r["stall"].tolist(),
                    r["complete"].tolist(), r["dos"].tolist(),
                    r["fault_delay"].tolist(), self.engine, self.kind,
                    self.tag)]
        return self._txs

    def canonical_lines(self) -> List[str]:
        """Canonical renderings straight from the columns — a digest of a
        batch-built log never has to materialize Transaction objects."""
        r = self.rec
        out = []
        for t, a, nb, st, c, e, k, tag in zip(
                r["time"].tolist(), r["addr"].tolist(),
                r["nbytes"].tolist(), r["stall"].tolist(),
                r["complete"].tolist(), self.engine, self.kind, self.tag):
            line = (f"{t:.6f} {e} {k} {a:#x} {nb} stall={st:.6f} "
                    f"complete={c:.6f}")
            if tag:
                line += f" tag={tag}"
            out.append(line)
        return out


@dataclasses.dataclass
class OpMark:
    """One profiled operation window: which slice of a ``TransactionLog``
    (and which span of the modeled clock) belongs to one logical op — an
    accelerator launch, a fabric collective leg, a serving tick.  Recorded
    by the ``profile=`` hooks (bridge.py, fabric.py) and consumed by
    ``core/profiler.py`` for per-op data-movement attribution (paper §IV,
    Fig. 8)."""
    op: str                     # "mm@oracle", "all_reduce", "scatter", ...
    engine: str                 # owning engine/channel hint
    t0: float                   # modeled clock at op entry
    t1: float                   # modeled clock at op exit
    tx_lo: int                  # first owned tx index in the log
    tx_hi: int                  # one past the last owned tx index
    meta: str = ""              # phase detail (e.g. "reduce_scatter[0]")


@contextlib.contextmanager
def record_mark(marks: List[OpMark], log: "TransactionLog",
                now: Callable[[], float], op: str, engine: str = "",
                meta: str = ""):
    """THE op-mark recorder: capture the clock + log cursor around a
    block and append one ``OpMark``.  Shared by the bridge's ``mark`` and
    the fabric's ``_mark`` so the two cannot drift; callers gate on their
    own ``profile`` flag (a disabled profiler never reaches here).  Uses
    ``n_txs`` (a count, not the materialized list) so marking never
    flushes lazy batch segments."""
    t0, lo = now(), log.n_txs
    try:
        yield
    finally:
        marks.append(OpMark(op, engine, t0, now(), lo, log.n_txs, meta))


def split_bursts(time: float, engine: str, kind: str, addr: int,
                 nbytes: int, tag: str, step: int) -> List[Transaction]:
    """Split one transfer into link-level bursts of at most ``step`` bytes
    (0 = never split).  Object-path twin of ``BurstBatch.from_transfer``
    — the batched splitter the bridge/fabric/serving hot paths now use —
    kept as the reference the differential tier compares against."""
    if step <= 0 or nbytes <= step:
        return [Transaction(time, engine, kind, addr, nbytes, tag=tag)]
    return [Transaction(time, engine, kind, addr + off,
                        min(step, nbytes - off), tag=tag)
            for off in range(0, nbytes, step)]


class TransactionLog:
    """Burst log + two audit channels.

    ``violations`` records protocol breaches observed by the hardware side
    (unmapped access, RO write, doorbell-while-busy, ...).  ``faults``
    records *deliberately injected* perturbations from a fault plan
    (core/fuzz.py) — delayed/reordered/split bursts, healed bit flips,
    congestion perturbation.  Keeping the channels separate lets the fuzz
    harness assert that every injected fault was audited without the
    injection itself failing a sweep's ``passed`` check.

    The transaction stream is lazy: arbitrated ``BurstBatch`` segments
    are appended by ``log_batch`` and only materialized into Transaction
    objects when ``txs`` is actually read.  Canonicalization is lazy too
    — rendered lines and the running sha256 are cached append-only and
    invalidated on ``set_state`` (the one mutation that isn't an append),
    so repeated ``digest()`` calls cost only the new suffix.
    """

    def __init__(self) -> None:
        self._txs: List[Transaction] = []
        self._pending: List[BurstBatch] = []
        self._n_pending = 0
        self.violations: List[str] = []
        self.faults: List[str] = []
        # lazy canonicalization caches: rendered tx lines for a logical
        # prefix of the stream, the sha256 over exactly those lines, and
        # a keyed memo of the last full digest.  ``_epoch`` bumps on
        # set_state so a restored stream can never alias a stale key.
        self._lines: List[str] = []
        self._tx_hash = hashlib.sha256()
        self._digest_memo: Optional[Tuple[Tuple, str]] = None
        self._epoch = 0

    # ------------------------------------------------------- lazy segments
    @property
    def txs(self) -> List[Transaction]:
        """The materialized transaction stream.  Reading this flushes any
        pending batch segments into Transaction objects; hot paths that
        only need counts/lines use ``n_txs``/``lines_since`` instead."""
        if self._pending:
            self._flush()
        return self._txs

    @property
    def n_txs(self) -> int:
        """Logical transaction count — flush-free (cursor/marks hot path)."""
        return len(self._txs) + self._n_pending

    def _flush(self) -> None:
        for b in self._pending:
            self._txs.extend(b.materialize())
        self._pending.clear()
        self._n_pending = 0

    def log(self, tx: Transaction) -> None:
        if self._pending:
            self._flush()
        self._txs.append(tx)

    def extend(self, txs: Iterable[Transaction]) -> None:
        if self._pending:
            self._flush()
        self._txs.extend(txs)

    def log_batch(self, batch: BurstBatch) -> None:
        """Append one arbitrated burst batch as a lazy segment (the
        batched hot path's ``log``)."""
        self._pending.append(batch)
        self._n_pending += len(batch)

    def violation(self, msg: str) -> None:
        self.violations.append(msg)

    def fault(self, msg: str) -> None:
        """Audit one injected fault (never silently absorbed)."""
        self.faults.append(msg)

    def audit(self) -> Dict[str, int]:
        """Counts for the violation/fault audit channels."""
        return {"violations": len(self.violations), "faults": len(self.faults)}

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict:
        """Snapshot of the log for a replay checkpoint (core/replay.py).
        Logged entries are shared, not copied: a Transaction is mutated
        only BEFORE it is logged (congestion arbitration, fault perturb),
        so the list prefix is immutable and checkpointing stays O(n) per
        snapshot instead of O(history)."""
        return {"txs": list(self.txs),
                "violations": list(self.violations),
                "faults": list(self.faults)}

    def set_state(self, state: Dict) -> None:
        """Restore a snapshot IN PLACE — the log object keeps its identity,
        so a bridge + register file sharing one log stay wired after a
        checkpoint restore.  Entries are aliased under the same
        immutable-once-logged invariant as ``get_state`` — the restore
        path is the replay hot loop (bench_replay.py economics).  The
        restored stream may share no prefix with the cached rendering, so
        every canonicalization cache is invalidated here."""
        self._pending.clear()
        self._n_pending = 0
        self._txs[:] = state["txs"]
        self.violations[:] = state["violations"]
        self.faults[:] = state["faults"]
        self._lines = []
        self._tx_hash = hashlib.sha256()
        self._digest_memo = None
        self._epoch += 1

    def cursor(self) -> Tuple[int, int, int]:
        """(txs, violations, faults) lengths — a position in the stream,
        used by replay windows to attribute new entries to one timeline
        op.  Flush-free."""
        return (self.n_txs, len(self.violations), len(self.faults))

    def lines_since(self, cur: Tuple[int, int, int]) -> List[str]:
        """Canonical lines appended after ``cursor()`` returned ``cur``,
        in op-emission order (txs, then violations, then faults)."""
        nt, nv, nf = cur
        self._render()
        lines = list(self._lines[nt:])
        lines += [f"violation: {v}" for v in self.violations[nv:]]
        lines += [f"fault: {f}" for f in self.faults[nf:]]
        return lines

    # ------------------------------------------------- golden-trace format
    @staticmethod
    def canonical_line(t: Transaction) -> str:
        """Stable rendering of ONE transaction — the unit the golden-trace
        format, the replay window digests (core/replay.py), and the
        divergence reports all share, so a burst can never render two ways.

        Floats are fixed to 6 decimals so the text (and its digest) is
        identical across platforms and numpy versions.
        """
        line = (f"{t.time:.6f} {t.engine} {t.kind} {t.addr:#x} "
                f"{t.nbytes} stall={t.stall:.6f} "
                f"complete={t.complete:.6f}")
        if t.tag:
            line += f" tag={t.tag}"
        return line

    def _render(self) -> None:
        """Extend the append-only line cache (and its running sha256) to
        cover the whole logical stream — pending segments render straight
        from their columns, so this never materializes Transactions."""
        done = len(self._lines)
        new: List[str] = []
        if done < len(self._txs):
            new += [self.canonical_line(t) for t in self._txs[done:]]
            done = len(self._txs)
        pos = len(self._txs)
        for b in self._pending:
            end = pos + len(b)
            if done < end:
                lines = b.canonical_lines()
                new += lines[done - pos:] if done > pos else lines
                done = end
            pos = end
        for line in new:
            self._tx_hash.update(line.encode())
            self._tx_hash.update(b"\n")
        self._lines += new

    def canonical(self) -> List[str]:
        """Stable one-line-per-transaction rendering of the stream plus the
        audit channels — the golden-trace format (tests/golden/*.trace)."""
        self._render()
        lines = list(self._lines)
        lines += [f"violation: {v}" for v in self.violations]
        lines += [f"fault: {f}" for f in self.faults]
        return lines

    def digest(self) -> str:
        """sha256 over the canonical trace — the seeded-reproducibility
        witness used by the golden-trace regression tests and the fabric
        same-seed checks.  Digest-on-demand: the tx-line prefix hash is
        cached append-only, so a repeat digest costs only the lines added
        since the last one (tests/test_simspeed.py pins invalidation
        across log/extend/violation/fault/set_state)."""
        key = (self._epoch, self.n_txs, len(self.violations),
               len(self.faults))
        if self._digest_memo is not None and self._digest_memo[0] == key:
            return self._digest_memo[1]
        self._render()
        h = self._tx_hash.copy()
        for v in self.violations:
            h.update(f"violation: {v}".encode())
            h.update(b"\n")
        for f in self.faults:
            h.update(f"fault: {f}".encode())
            h.update(b"\n")
        out = h.hexdigest()
        self._digest_memo = (key, out)
        return out

    # ------------------------------------------------------------ queries
    def total_bytes(self, engine: Optional[str] = None) -> int:
        return sum(t.nbytes for t in self.txs
                   if engine is None or t.engine == engine)

    def engines(self) -> List[str]:
        return sorted({t.engine for t in self.txs})

    def total_stalls(self, engine: Optional[str] = None) -> float:
        return sum(t.stall for t in self.txs
                   if engine is None or t.engine == engine)

    # ------------------------------------------------------- Fig 8 analogue
    def bandwidth_timeline(self, n_buckets: int = 50,
                           by_engine: bool = True
                           ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Returns (bucket_edges, {engine: bytes_per_bucket})."""
        if not self.txs:
            return np.zeros(1), {}
        stamp = lambda t: t.complete if t.complete else t.time
        t_end = max(stamp(t) for t in self.txs) or 1.0
        edges = np.linspace(0.0, t_end, n_buckets + 1)
        out: Dict[str, np.ndarray] = defaultdict(
            lambda: np.zeros(n_buckets))
        for t in self.txs:
            b = min(int(stamp(t) / t_end * n_buckets), n_buckets - 1)
            out[t.engine if by_engine else "all"][b] += t.nbytes
        return edges, dict(out)

    # ------------------------------------------------------- Fig 9 analogue
    def heatmap(self, addr_bins: int = 32, time_bins: int = 64,
                kind: Optional[str] = None) -> np.ndarray:
        """(addr_bins, time_bins) access-count heatmap."""
        txs = [t for t in self.txs if kind is None or t.kind == kind]
        hm = np.zeros((addr_bins, time_bins))
        if not txs:
            return hm
        t_end = max(t.time for t in txs) or 1.0
        a_end = max(t.addr + t.nbytes for t in txs) or 1
        for t in txs:
            ai = min(int(t.addr / a_end * addr_bins), addr_bins - 1)
            ti = min(int(t.time / t_end * time_bins), time_bins - 1)
            hm[ai, ti] += t.nbytes
        return hm

    def render_heatmap(self, addr_bins: int = 24, time_bins: int = 64,
                       kind: Optional[str] = None) -> str:
        """ASCII heatmap (density ramp) for terminal/benchmark output."""
        hm = self.heatmap(addr_bins, time_bins, kind)
        ramp = " .:-=+*#%@"
        mx = hm.max() or 1.0
        lines = []
        for row in hm[::-1]:                       # high addresses on top
            lines.append("".join(
                ramp[min(int(v / mx * (len(ramp) - 1)), len(ramp) - 1)]
                for v in row))
        return "\n".join(lines)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for e in self.engines():
            txs = [t for t in self.txs if t.engine == e]
            out[e] = {
                "transactions": len(txs),
                "bytes": sum(t.nbytes for t in txs),
                "reads": sum(1 for t in txs if t.kind == "read"),
                "writes": sum(1 for t in txs if t.kind == "write"),
                "stall": sum(t.stall for t in txs),
            }
        return out
