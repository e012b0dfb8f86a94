"""Off-chip data-movement profiling engine (paper §IV, Figs. 8 and 9).

The paper names off-chip data-movement profiling as one of the three
capabilities a co-verification bridge must provide (§I, alongside memory
congestion emulation and register-level protocol testing).  This module is
that third pillar as a first-class subsystem: a ``DataMovementProfiler``
consumes the transaction streams and link-arbiter state an instrumented
target already carries — a ``FireBridge``/``MemoryBridge``, a
``FabricCluster``, a ``ServingEngine``/``ClusterServingEngine``, or a
replayed ``Recording`` (core/replay.py) — and produces:

* **Exhaustive stall attribution** — every modeled cycle of every channel
  is classified into exactly one category (the taxonomy below), and the
  per-category breakdown sums *exactly* to the channel's modeled
  completion time (``bridge.time`` for the DDR channel) — the closure
  property the regression tests assert.
* **Per-channel / per-engine / per-op timelines** — the Fig. 8 series
  (per-DMA-engine stalls and busy cycles, link utilization) plus per-op
  attribution from the ``profile=`` op marks recorded at launch and
  collective boundaries.
* **Chrome-trace / Perfetto JSON export** — one track per DMA channel,
  fabric port, and serving engine; a stall slice plus a transfer slice
  per burst; bandwidth counter tracks; byte-identical under the same
  seed.  Load the file at https://ui.perfetto.dev (schema documented in
  docs/profiling.md and enforced by ``validate_trace``).
* **Roofline placement** — ``RooflinePlacement`` puts a kernel or a whole
  program on the roofline from its modeled time terms.

Stall-attribution taxonomy (one wall partition per channel):

  ``transfer``       link busy moving a burst, no competing burst waiting
  ``contention``     link busy while >=1 other burst waits for it (the
                     Fig. 8 "memory stalls" source)
  ``serialization``  link idle: next burst's engine still in its
                     per-engine issue gap
  ``dos``            link withheld by the seeded denial-of-service
                     injection (§IV-C)
  ``fault_delay``    link idle: pending burst's min-issue time pushed by
                     an injected ``dma_delay`` fault (core/fuzz.py)
  ``compute``        link idle with no burst submitted — firmware/backend
                     compute with no DMA outstanding (compute overlap)

Closure is by construction: the idle/dos/contention categories are
measured, ``transfer`` is defined as the remainder to the channel horizon,
and an internal consistency check (``ChannelProfile.residual``) verifies
the remainder against the sum of modeled burst transfer times.

This is the port of ``repro.core.profiler``: pure host code over modeled
cycles, so its rows and Perfetto files are byte for byte the reference's
for the same run, whichever device ran the accelerator ops.
"""
from __future__ import annotations

import dataclasses
import json
import math
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.bridge import FireBridge, MemoryBridge
from repro_torch.core.congestion import CongestionConfig, LinkModel
from repro_torch.core.fabric import FabricCluster
from repro_torch.core.transactions import OpMark, Transaction, TransactionLog

__all__ = [
    "CATEGORIES", "StallBreakdown", "EngineStats", "ChannelProfile",
    "DataMovementProfiler", "RooflinePlacement", "profile_recording",
    "profile_window", "validate_trace", "SCHEMA_VERSION",
]

# the exhaustive wall-partition categories, in taxonomy order
CATEGORIES = ("transfer", "contention", "serialization", "dos",
              "fault_delay", "compute")

SCHEMA_VERSION = 1


# --------------------------------------------------------------- breakdown
@dataclasses.dataclass
class StallBreakdown:
    """Exhaustive per-category cycle attribution of one channel (§IV-C).

    ``cycles`` maps every category in ``CATEGORIES`` to modeled cycles;
    the values sum exactly to ``total`` (the channel's modeled completion
    time — ``bridge.time`` for a device DDR channel)."""
    total: float
    cycles: Dict[str, float]

    @classmethod
    def close(cls, total: float, measured: Dict[str, float],
              remainder: str = "transfer") -> "StallBreakdown":
        """Build a closed breakdown: measured categories as given, the
        ``remainder`` category defined as ``total - sum(measured)`` so the
        partition sums exactly to ``total`` by construction."""
        cycles = {c: 0.0 for c in CATEGORIES}
        cycles.update(measured)
        cycles[remainder] = total - sum(v for c, v in cycles.items()
                                        if c != remainder)
        # float fix-up: re-summing in category order can drift by an ulp.
        # Walk the largest category (whose ulp is within one ulp of the
        # total's, so each step moves the fold by at most one ulp) until
        # the left-fold sum equals ``total`` bit-exactly — the closure
        # property the regression tests assert.  The adjustment is a few
        # ulps at most: semantically zero cycles.
        carrier = max(CATEGORIES, key=lambda c: abs(cycles[c]))
        if not _walk(cycles, carrier, total):
            # the walk can miss: each step of the carrier passes through
            # several roundings of the fold, which can step over ``total``
            # from either side (the reference stops here, unclosed).  The
            # fold's last term enters through one rounding only, monotone
            # in it: restart it from the exact remainder and walk it.
            last = CATEGORIES[-1]
            s = 0.0
            for c in CATEGORIES[:-1]:
                s += cycles[c]
            cycles[last] = total - s
            _walk(cycles, last, total)
        return cls(total, cycles)

    def fractions(self) -> Dict[str, float]:
        t = self.total or 1.0
        return {c: self.cycles[c] / t for c in CATEGORIES}

    def rows(self) -> List[str]:
        """category,cycles,percent rows (taxonomy order)."""
        out = []
        for c in CATEGORIES:
            v = self.cycles[c]
            out.append(f"{c},{v:.0f},{100.0 * v / (self.total or 1.0):.1f}")
        return out


def _walk(cycles: Dict[str, float], carrier: str, total: float) -> bool:
    """Step ``cycles[carrier]`` one ulp at a time (at most 128 steps)
    until the left fold over ``CATEGORIES`` equals ``total``; True when it
    does."""
    for _ in range(128):
        s = 0.0
        for c in CATEGORIES:
            s += cycles[c]
        if s == total:
            return True
        cycles[carrier] = math.nextafter(
            cycles[carrier], math.inf if s < total else -math.inf)
    return False


@dataclasses.dataclass
class EngineStats:
    """Per-engine Fig. 8 series on one channel."""
    transactions: int = 0
    bytes: int = 0
    busy: float = 0.0           # modeled transfer cycles
    contention: float = 0.0     # wait-for-link cycles (stall minus DoS)
    dos: float = 0.0
    fault_delay: float = 0.0
    # fold of tx.stall in grant order — BIT-exactly the arbiter's own
    # per-engine stall accumulator (``CongestionResult.per_engine_stall``
    # and the ``stall_cycles`` counter probe fold the same terms in the
    # same order), where ``contention + dos`` re-associates the sum
    grant_stall: float = 0.0

    @property
    def stall(self) -> float:
        """wait + DoS — matches ``CongestionResult.per_engine_stall``."""
        return self.contention + self.dos


@dataclasses.dataclass
class ChannelProfile:
    """One profiled channel (§IV-C): a shared DDR link, a fabric port,
    the host↔fabric channel, a fast-path logical-clock bridge, or a CSR
    protocol clock (§IV-A) — the unit of the paper's per-interconnect
    Fig. 8 readout.

    ``kind`` is "link" (congestion-arbitrated), "clock" (fast-path
    logical clock), or "csr" (register-protocol clock).  ``horizon`` is
    the channel's modeled completion time; ``breakdown`` partitions
    ``[0, horizon)`` exhaustively.  ``residual`` is the internal
    consistency check: |closing remainder - independently summed transfer
    cycles| (should be ~0; float noise only)."""
    name: str
    kind: str
    horizon: float
    breakdown: StallBreakdown
    engines: Dict[str, EngineStats]
    txs: List[Transaction]
    cfg: Optional[CongestionConfig]
    residual: float

    @property
    def total_bytes(self) -> int:
        return sum(e.bytes for e in self.engines.values())

    @property
    def utilization(self) -> float:
        """Link-bandwidth utilization over the horizon (Fig. 8) — matches
        ``CongestionResult.link_utilization`` for link channels."""
        if self.kind != "link" or not self.horizon:
            return 0.0
        return (self.total_bytes
                / self.cfg.link_bytes_per_cycle) / self.horizon


def _merged(intervals: List[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(busy: List[Tuple[float, float]],
             waits: List[Tuple[float, float]]) -> float:
    """Total length of ``busy`` covered by the union of ``waits`` (both
    sorted; busy intervals are link-serialized and disjoint)."""
    tot, j = 0.0, 0
    for a, b in busy:
        while j < len(waits) and waits[j][1] <= a:
            j += 1
        k = j
        while k < len(waits) and waits[k][0] < b:
            tot += max(0.0, min(b, waits[k][1]) - max(a, waits[k][0]))
            k += 1
    return tot


def _profile_link(name: str, link: LinkModel) -> ChannelProfile:
    """Attribute a congestion-arbitrated channel (§IV-C): walk the link's
    arbitration-order timeline reconstructing each burst's issue/start
    from its recorded fields, classify every idle gap (compute vs
    fault-delay vs serialization, layered by what was holding the burst
    back), overlay waiting demand onto busy time (contention), and close
    the partition with the transfer remainder."""
    cfg = link.cfg
    idle = {"compute": 0.0, "serialization": 0.0, "fault_delay": 0.0}
    dos_total = 0.0
    busy: List[Tuple[float, float]] = []
    waits: List[Tuple[float, float]] = []
    engines: Dict[str, EngineStats] = defaultdict(EngineStats)
    xfer_sum = 0.0
    prev_free = 0.0
    # one property read: materializes any lazy batch segments exactly once
    # (per-tx dos/fault_delay attribution columns survive vectorization)
    timeline = link.timeline
    for tx in timeline:
        xfer = cfg.base_latency + tx.nbytes / cfg.link_bytes_per_cycle
        start = tx.complete - tx.dos - xfer
        wait = tx.stall - tx.dos
        issue = start - wait
        if issue > prev_free:
            # layered gap attribution: below the batch's submit time the
            # firmware had not produced the burst yet (compute overlap);
            # between submit and the fault-pushed min-issue time the link
            # idled on an injected dma_delay; the rest is the engine's
            # issue-gap serialization
            base = tx.time - tx.fault_delay
            c_end = min(issue, max(prev_free, base))
            f_end = min(issue, max(c_end, tx.time))
            idle["compute"] += max(0.0, c_end - prev_free)
            idle["fault_delay"] += max(0.0, f_end - c_end)
            idle["serialization"] += max(0.0, issue - f_end)
        dos_total += tx.dos
        if wait > 0.0:
            waits.append((issue, start))
        busy.append((start + tx.dos, tx.complete))
        prev_free = tx.complete
        e = engines[tx.engine]
        e.transactions += 1
        e.bytes += tx.nbytes
        e.busy += xfer
        e.contention += wait
        e.dos += tx.dos
        e.fault_delay += tx.fault_delay
        e.grant_stall += tx.stall
        xfer_sum += xfer
    contended = _overlap(busy, _merged(waits))
    total = link.now
    bd = StallBreakdown.close(total, dict(idle, dos=dos_total,
                                          contention=contended))
    residual = abs(bd.cycles["transfer"] + contended - xfer_sum)
    return ChannelProfile(name, "link", total, bd, dict(engines),
                          list(timeline), cfg, residual)


def _profile_clock(name: str, mem: MemoryBridge,
                   exclude_engines: frozenset) -> ChannelProfile:
    """Attribute a fast-path (congestion-free) bridge: one logical cycle
    of transfer per access; clock jumps beyond that are fault delay (up
    to the burst's recorded ``fault_delay``) and compute overlap
    (min-issue times ahead of the clock)."""
    txs = [t for t in mem.log.txs if t.engine not in exclude_engines]
    idle = {"compute": 0.0, "fault_delay": 0.0}
    engines: Dict[str, EngineStats] = defaultdict(EngineStats)
    prev = 0.0
    for tx in txs:
        seg = tx.time - prev
        extra = max(0.0, seg - 1.0)
        f = min(extra, tx.fault_delay)
        idle["fault_delay"] += f
        idle["compute"] += extra - f
        prev = tx.time
        e = engines[tx.engine]
        e.transactions += 1
        e.bytes += tx.nbytes
        e.busy += min(seg, 1.0)
        e.fault_delay += tx.fault_delay
    total = mem.time
    bd = StallBreakdown.close(total, idle)
    residual = abs(bd.cycles["transfer"]
                   - sum(e.busy for e in engines.values()))
    return ChannelProfile(name, "clock", total, bd, dict(engines), txs,
                          None, residual)


def _profile_csr(name: str, csr: Any) -> ChannelProfile:
    """Attribute a register-protocol clock (§IV-A): every ``fb_read_32``/
    ``fb_write_32`` is one protocol tick of pure transfer."""
    txs = [t for t in csr.log.txs if t.engine == csr.name]
    engines: Dict[str, EngineStats] = defaultdict(EngineStats)
    for tx in txs:
        e = engines[tx.engine]
        e.transactions += 1
        e.bytes += tx.nbytes
        e.busy += 1.0
    total = float(csr.time)
    bd = StallBreakdown.close(total, {})
    residual = abs(bd.cycles["transfer"]
                   - sum(e.busy for e in engines.values()))
    return ChannelProfile(name, "csr", total, bd, dict(engines), txs,
                          None, residual)


def _bridge_channels(prefix: str, fb: FireBridge) -> List[ChannelProfile]:
    mem, csr = fb.mem, fb.csr
    if mem.link is not None:
        ddr = _profile_link(f"{prefix}ddr", mem.link)
    else:
        ddr = _profile_clock(f"{prefix}ddr", mem, frozenset({csr.name}))
    return [ddr, _profile_csr(f"{prefix}csr", csr)]


def _is_cluster_serving(target: Any) -> bool:
    return hasattr(target, "engines") and hasattr(target, "csr")


def _is_serving(target: Any) -> bool:
    return hasattr(target, "slots") and hasattr(target, "step")


def _request_spans(engines) -> List[dict]:
    """Completed continuous-batching request lifecycles as (queue,
    prefill, decode) spans in modeled cycles.  Captured at profiler
    construction — the profiler does not retain its target — from the
    ``(device, engine)`` pairs given.  Storm-mode requests carry no
    admission stamps (t_admit == -1) and are skipped, so legacy serving
    profiles are unchanged."""
    spans = []
    for dev, eng in engines:
        for rid, req in eng.requests.items():
            if req.t_admit < 0 or req.t_done < 0:
                continue                # storm-mode or still in flight
            spans.append({"rid": int(rid), "device": int(dev),
                          "t_submit": float(req.t_submit),
                          "t_admit": float(req.t_admit),
                          "t_first": float(req.t_first),
                          "t_done": float(req.t_done),
                          "tokens": len(req.out_tokens)})
    return sorted(spans, key=lambda s: (s["t_submit"], s["rid"]))


# ------------------------------------------------------------ the profiler
class DataMovementProfiler:
    """Off-chip data-movement profiler (paper §IV, the third pillar).

    Build one over any instrumented target and read the report::

        fb = FireBridge(congestion=cfg, profile=True)
        ... firmware runs ...
        prof = DataMovementProfiler(fb)        # or fb.profiler()
        prof.breakdown()["ddr"].cycles         # closes to fb.mem.time
        prof.save_perfetto("run.trace.json")   # open in ui.perfetto.dev

    Accepted targets: ``FireBridge``/``MemoryBridge`` (one DDR channel +
    the CSR protocol clock), ``FabricCluster`` (host↔fabric channel,
    every port, every device), ``ServingEngine`` / ``ClusterServingEngine``
    (prompt-upload vs token-writeback traffic), and — via
    ``profile_recording`` — any replayed ``Recording``.
    """

    def __init__(self, target: Any, label: str = "run") -> None:
        self.label = label
        self.channels: List[ChannelProfile] = []
        self.marks: List[Tuple[TransactionLog, OpMark]] = []
        # serving targets only: completed request lifecycles (see
        # _request_spans); empty for bridge/fabric targets
        self.requests: List[dict] = []
        # resolve eagerly and do NOT retain the target: channels/marks
        # alias only logs and link timelines, so a profiled sweep cell
        # does not pin its bridge's DDR buffers for the report's lifetime
        self._resolve(target)
        self._by_name = {c.name: c for c in self.channels}
        # sampled counter streams (core/counters.py), snapshotted as
        # plain tuples — bank probes close over the target, so retaining
        # the banks themselves would break the no-pin discipline above
        from repro_torch.core.counters import counter_banks as _banks_of
        self.counter_tracks: List[Tuple[str, List[Tuple[str, str]],
                                        List[float], List[tuple]]] = [
            (b.name, [(s.name, s.unit) for s in b.specs],
             list(b.stream.times), list(b.stream.rows))
            for b in _banks_of(target)]

    # ---------------------------------------------------------- resolution
    def _resolve(self, target: Any) -> None:
        if isinstance(target, FabricCluster):
            self.channels.append(_profile_link("fabric/host",
                                               target.host_link))
            for i, p in enumerate(target.ports):
                self.channels.append(_profile_link(f"fabric/port{i}", p))
            if target.switch is not None:
                # routed fabric: one channel (and Perfetto track) per
                # switch port — per-hop contention attribution
                for label, link in target.switch.labeled_links():
                    self.channels.append(
                        _profile_link(f"fabric/{label}", link))
            for i, d in enumerate(target.devices):
                self.channels.extend(_bridge_channels(f"d{i}/", d))
                self.marks.extend((d.log, m) for m in d.mem.marks)
            self.marks.extend((target.log, m) for m in target.marks)
            self._primary_log = target.log
            return
        if isinstance(target, FireBridge):
            self.channels.extend(_bridge_channels("", target))
            self.marks.extend((target.log, m) for m in target.mem.marks)
            self._primary_log = target.log
            return
        if isinstance(target, MemoryBridge):
            if target.link is not None:
                self.channels.append(_profile_link("ddr", target.link))
            else:
                self.channels.append(_profile_clock("ddr", target,
                                                    frozenset()))
            self.marks.extend((target.log, m) for m in target.marks)
            self._primary_log = target.log
            return
        if _is_cluster_serving(target):
            self.channels.append(_profile_link("host", target.host_link))
            self.channels.append(_profile_csr("csr", target.csr))
            sw = getattr(target, "switch", None)
            if sw is not None:
                for label, link in sw.labeled_links():
                    self.channels.append(_profile_link(f"sw/{label}",
                                                       link))
            for i, eng in enumerate(target.engines):
                if eng.mem.link is not None:
                    self.channels.append(
                        _profile_link(f"e{i}/ddr", eng.mem.link))
                else:
                    self.channels.append(_profile_clock(
                        f"e{i}/ddr", eng.mem, frozenset({eng.csr.name})))
                self.channels.append(_profile_csr(f"e{i}/csr", eng.csr))
            self.requests = _request_spans(enumerate(target.engines))
            self._primary_log = target.log
            return
        if _is_serving(target):
            if target.mem.link is not None:
                self.channels.append(_profile_link("ddr", target.mem.link))
            else:
                self.channels.append(_profile_clock(
                    "ddr", target.mem, frozenset({target.csr.name})))
            self.channels.append(_profile_csr("csr", target.csr))
            self.requests = _request_spans([(0, target)])
            self._primary_log = target.mem.log
            return
        raise TypeError(f"no profiling mapping for "
                        f"{type(target).__name__}")

    # ------------------------------------------------------------- queries
    def channel(self, name: str) -> ChannelProfile:
        return self._by_name[name]

    def breakdown(self) -> Dict[str, StallBreakdown]:
        """Per-channel exhaustive stall attribution; each breakdown sums
        exactly to its channel's modeled completion time."""
        return {c.name: c.breakdown for c in self.channels}

    def attribution(self) -> Dict[str, float]:
        """Category cycles summed over every channel (the sweep-report
        columns).  Per-channel closure still holds individually."""
        out = {c: 0.0 for c in CATEGORIES}
        for ch in self.channels:
            for c in CATEGORIES:
                out[c] += ch.breakdown.cycles[c]
        return out

    def utilization(self) -> float:
        """Primary-channel link utilization (0.0 for fast-path runs)."""
        return self.channels[0].utilization if self.channels else 0.0

    def engine_rows(self) -> List[str]:
        """Fig. 8 per-engine series, one CSV row per (channel, engine)."""
        rows = ["channel,engine,transactions,bytes,busy_cycles,"
                "contention_cycles,dos_cycles,fault_delay_cycles"]
        for ch in self.channels:
            for e in sorted(ch.engines):
                s = ch.engines[e]
                rows.append(f"{ch.name},{e},{s.transactions},{s.bytes},"
                            f"{s.busy:.0f},{s.contention:.0f},{s.dos:.0f},"
                            f"{s.fault_delay:.0f}")
        return rows

    def op_rows(self) -> List[str]:
        """Per-op attribution from the ``profile=`` op marks: bytes moved,
        stall/DoS/fault cycles, and modeled span per launch or collective
        leg (the Fig. 8 per-operation view)."""
        rows = ["op,meta,transactions,bytes,stall_cycles,dos_cycles,"
                "fault_delay_cycles,span_cycles"]
        for log, m in self.marks:
            txs = log.txs[m.tx_lo:m.tx_hi]
            rows.append(
                f"{m.op},{m.meta},{len(txs)},"
                f"{sum(t.nbytes for t in txs)},"
                f"{sum(t.stall for t in txs):.0f},"
                f"{sum(t.dos for t in txs):.0f},"
                f"{sum(t.fault_delay for t in txs):.0f},"
                f"{m.t1 - m.t0:.0f}")
        return rows

    def serving_rows(self) -> List[str]:
        """Prompt-upload vs token-writeback attribution for serving
        targets: upload = device-bound reads/writes (``h->e*`` /
        ``serve_dma`` reads), writeback = host-bound token rows.  The two
        directions contend on one channel — their stall split is the
        serving Fig. 8 readout."""
        up = EngineStats()
        back = EngineStats()
        # cluster targets: the shared host channel is where uploads and
        # writebacks contend — counting device-local serve_dma traffic
        # too would double-book every token row
        chans = ([self._by_name["host"]] if "host" in self._by_name
                 else self.channels)
        for ch in chans:
            for name, s in ch.engines.items():
                if ch.kind == "csr":
                    continue
                dest = (back if ("->h" in name or name.endswith("_wr"))
                        else up)
                if name == "serve_dma":
                    # single engine: reads fetch prompts, writes stream
                    # token rows back — split by kind
                    for tx in ch.txs:
                        if tx.engine != name:
                            continue
                        d = up if tx.kind == "read" else back
                        d.transactions += 1
                        d.bytes += tx.nbytes
                        d.contention += tx.stall - tx.dos
                        d.dos += tx.dos
                    continue
                dest.transactions += s.transactions
                dest.bytes += s.bytes
                dest.busy += s.busy
                dest.contention += s.contention
                dest.dos += s.dos
        rows = ["direction,transactions,bytes,stall_cycles"]
        rows.append(f"prompt_upload,{up.transactions},{up.bytes},"
                    f"{up.stall:.0f}")
        rows.append(f"token_writeback,{back.transactions},{back.bytes},"
                    f"{back.stall:.0f}")
        return rows

    def request_rows(self) -> List[str]:
        """Per-request lifecycle rows for continuous-batching serving
        targets — the latency-SLO tier's raw material: one CSV row per
        completed request with its queue/prefill/decode boundary stamps
        (modeled cycles) and generated token count."""
        rows = ["rid,device,t_submit,t_admit,t_first,t_done,tokens"]
        for s in self.requests:
            rows.append(f"{s['rid']},{s['device']},{s['t_submit']:.1f},"
                        f"{s['t_admit']:.1f},{s['t_first']:.1f},"
                        f"{s['t_done']:.1f},{s['tokens']}")
        return rows

    def bandwidth_timeline(self, n_buckets: int = 50,
                           by_engine: bool = True):
        """Bucketed bandwidth-utilization series of the primary log —
        the Fig. 8 timeline (delegates to
        ``TransactionLog.bandwidth_timeline``)."""
        return self._primary_log.bandwidth_timeline(n_buckets, by_engine)

    def roofline(self, flops_by_op: Dict[str, float], peak_flops: float,
                 mem_bw: float) -> List["RooflinePlacement"]:
        """Place each profiled op on the roofline: compute time from the
        caller-supplied FLOP counts, memory time from the bytes the op's
        marked transactions actually moved."""
        out = []
        for log, m in self.marks:
            if m.op not in flops_by_op:
                continue
            fl = flops_by_op[m.op]
            by = sum(t.nbytes for t in log.txs[m.tx_lo:m.tx_hi])
            out.append(RooflinePlacement(
                m.op, {"compute": fl / peak_flops, "memory": by / mem_bw},
                ideal_s=fl / peak_flops))
        return out

    # ------------------------------------------------------------- export
    def to_perfetto(self) -> dict:
        """Chrome-trace JSON (Perfetto-loadable): one process per channel,
        one thread per engine, a ``stall`` + transfer slice per burst,
        bandwidth counter tracks, per-op slices, and the per-channel
        stall attribution + horizons in ``otherData`` (schema in
        docs/profiling.md; checked by ``validate_trace``).  Modeled
        cycles are exported as microseconds (1 cycle = 1 us).
        Byte-identical under the same seed."""
        ev: List[dict] = []
        for pid, ch in enumerate(self.channels, start=1):
            ev.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"{self.label}/{ch.name}"}})
            engines = sorted(ch.engines)
            tids = {e: i + 1 for i, e in enumerate(engines)}
            for e in engines:
                ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[e], "args": {"name": e}})
            for tx in ch.txs:
                tid = tids[tx.engine]
                if ch.kind == "link":
                    xfer = (ch.cfg.base_latency
                            + tx.nbytes / ch.cfg.link_bytes_per_cycle)
                    start = tx.complete - tx.dos - xfer
                    if tx.stall > 0.0:
                        ev.append({
                            "ph": "X", "cat": "stall", "name": "stall",
                            "ts": round(start - (tx.stall - tx.dos), 6),
                            "dur": round(tx.stall, 6),
                            "pid": pid, "tid": tid,
                            "args": {"dos": round(tx.dos, 6),
                                     "fault_delay": round(tx.fault_delay,
                                                          6)}})
                    ts, dur = start + tx.dos, xfer
                else:
                    ts, dur = tx.time - 1.0, 1.0
                ev.append({
                    "ph": "X", "cat": tx.kind,
                    "name": tx.tag or f"{tx.kind} {tx.nbytes}B",
                    "ts": round(ts, 6), "dur": round(dur, 6),
                    "pid": pid, "tid": tid,
                    "args": {"bytes": tx.nbytes,
                             "addr": f"{tx.addr:#x}"}})
            # bandwidth counter track (bytes per cycle per bucket)
            if ch.txs and ch.horizon > 0:
                n = 32
                width = ch.horizon / n
                buckets = [0.0] * n
                for tx in ch.txs:
                    stamp = tx.complete if tx.complete else tx.time
                    b = min(int(stamp / ch.horizon * n), n - 1)
                    buckets[b] += tx.nbytes
                for b, v in enumerate(buckets):
                    ev.append({"ph": "C", "name": "bandwidth",
                               "pid": pid, "ts": round(b * width, 6),
                               "args": {"bytes_per_cycle":
                                        round(v / width, 6)}})
        if self.marks:
            pid = len(self.channels) + 1
            ev.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"{self.label}/ops"}})
            ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 1, "args": {"name": "ops"}})
            for _, m in self.marks:
                ev.append({"ph": "X", "cat": "op",
                           "name": m.meta and f"{m.op}:{m.meta}" or m.op,
                           "ts": round(m.t0, 6),
                           "dur": round(max(m.t1 - m.t0, 1e-6), 6),
                           "pid": pid, "tid": 1,
                           "args": {"transactions": m.tx_hi - m.tx_lo}})
        if self.requests:
            # per-request lifecycle tracks (continuous-batching serving):
            # one thread per request, queue/prefill/decode slices
            pid = len(self.channels) + 1 + (1 if self.marks else 0)
            ev.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"{self.label}/requests"}})
            for tid, s in enumerate(self.requests, start=1):
                ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"rid{s['rid']}"
                                            f"@d{s['device']}"}})
                if s["t_admit"] > s["t_submit"]:
                    ev.append({"ph": "X", "cat": "queue", "name": "queue",
                               "ts": round(s["t_submit"], 6),
                               "dur": round(s["t_admit"] - s["t_submit"],
                                            6),
                               "pid": pid, "tid": tid,
                               "args": {"rid": s["rid"]}})
                ev.append({"ph": "X", "cat": "prefill", "name": "prefill",
                           "ts": round(s["t_admit"], 6),
                           "dur": round(max(s["t_first"] - s["t_admit"],
                                            1e-6), 6),
                           "pid": pid, "tid": tid,
                           "args": {"rid": s["rid"]}})
                ev.append({"ph": "X", "cat": "decode", "name": "decode",
                           "ts": round(s["t_first"], 6),
                           "dur": round(max(s["t_done"] - s["t_first"],
                                            1e-6), 6),
                           "pid": pid, "tid": tid,
                           "args": {"rid": s["rid"],
                                    "tokens": s["tokens"]}})
        if any(times for _, _, times, _ in self.counter_tracks):
            # sampled performance-counter tracks (core/counters.py): one
            # process per bank, one "C" series per counter
            pid = (len(self.channels) + 1 + (1 if self.marks else 0)
                   + (1 if self.requests else 0))
            for bank, cols, times, rows in self.counter_tracks:
                if not times:
                    continue
                ev.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name":
                                    f"{self.label}/counters/{bank}"}})
                for t, row in zip(times, rows):
                    for (cname, unit), v in zip(cols, row):
                        ev.append({"ph": "C", "name": cname, "pid": pid,
                                   "ts": round(t, 6),
                                   "args": {unit: round(float(v), 6)}})
                pid += 1
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            "otherData": {
                "label": self.label,
                "schema_version": SCHEMA_VERSION,
                "attribution": {c.name: {k: round(v, 6) for k, v in
                                         c.breakdown.cycles.items()}
                                for c in self.channels},
                "horizons": {c.name: round(c.horizon, 6)
                             for c in self.channels},
            },
        }

    def save_perfetto(self, path) -> Path:
        """Write the Chrome-trace JSON deterministically (sorted keys,
        compact separators): same seed ⇒ byte-identical file."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_perfetto(), sort_keys=True,
                                separators=(",", ":")) + "\n")
        return p

    def summary(self) -> dict:
        prim = self.channels[0]
        return {
            "label": self.label,
            "channels": len(self.channels),
            "transactions": sum(len(c.txs) for c in self.channels),
            "bytes": sum(c.total_bytes for c in self.channels),
            "horizon": round(prim.horizon, 1),
            "utilization": round(prim.utilization, 4),
            "attribution": {k: round(v, 1)
                            for k, v in self.attribution().items()},
        }


# ----------------------------------------------------- recording profiling
def profile_window(target: Any, rec: Any, lo: int, hi: int
                   ) -> Dict[str, Dict[str, float]]:
    """Per-engine data-movement totals (the Fig. 8 series, §IV) for the
    transactions that recording ops ``[lo, hi)`` emitted on ``target``
    (the original run's target, or the target a window replay left
    behind — the two are bit-identical by the replay contract, which the
    regression tests exploit).

    Only per-transaction attribution is reported (bytes, stall, DoS,
    fault delay) — the wall-partition categories need the full horizon
    and are reported by ``DataMovementProfiler`` on full-range targets.
    """
    from repro_torch.core import replay as rp
    out: Dict[str, Dict[str, float]] = {}
    for li, log in enumerate(rp.target_logs(target)):
        marks = rec.tx_marks[li]
        for tx in log.txs[marks[lo]:marks[hi]]:
            e = out.setdefault(tx.engine, {
                "transactions": 0.0, "bytes": 0.0, "stall": 0.0,
                "dos": 0.0, "fault_delay": 0.0})
            e["transactions"] += 1
            e["bytes"] += tx.nbytes
            e["stall"] += tx.stall
            e["dos"] += tx.dos
            e["fault_delay"] += tx.fault_delay
    return out


def profile_recording(session: Any, rec: Any,
                      label: Optional[str] = None) -> DataMovementProfiler:
    """Profile a recorded run after the fact (core/replay.py): replay the
    full timeline (bit-identical by the replay contract) and profile the
    regenerated target — so any recording, including the committed golden
    traces, can produce Fig. 8 attribution and a Perfetto trace on
    demand."""
    w = session.replay(rec, 0, rec.n_ops)
    return DataMovementProfiler(w.target, label=label or rec.label)


# ------------------------------------------------------------ trace schema
_REQUIRED = {
    "M": {"name", "ph", "pid", "args"},
    "X": {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"},
    "C": {"name", "ph", "ts", "pid", "args"},
}


def validate_trace(trace: dict) -> List[str]:
    """Validate an exported Chrome-trace object against the documented
    event schema (docs/profiling.md): required keys per phase, numeric
    non-negative timestamps, and the closure property — every channel's
    attribution must sum exactly to its recorded horizon.  Returns a list
    of problems (empty = valid)."""
    errs: List[str] = []
    if set(trace) != {"traceEvents", "displayTimeUnit", "otherData"}:
        errs.append(f"top-level keys {sorted(trace)} != "
                    f"['displayTimeUnit', 'otherData', 'traceEvents']")
        return errs
    for i, ev in enumerate(trace["traceEvents"]):
        ph = ev.get("ph")
        req = _REQUIRED.get(ph)
        if req is None:
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        missing = req - set(ev)
        if missing:
            errs.append(f"event {i} ({ph}): missing {sorted(missing)}")
            continue
        if ph in ("X", "C") and (not isinstance(ev["ts"], (int, float))
                                 or ev["ts"] < -1e-6):
            errs.append(f"event {i}: bad ts {ev['ts']!r}")
        if ph == "X" and (not isinstance(ev["dur"], (int, float))
                          or ev["dur"] < 0):
            errs.append(f"event {i}: bad dur {ev['dur']!r}")
        if not isinstance(ev.get("args"), dict):
            errs.append(f"event {i}: args must be a dict")
    other = trace["otherData"]
    for key in ("label", "schema_version", "attribution", "horizons"):
        if key not in other:
            errs.append(f"otherData missing {key!r}")
            return errs
    for name, cyc in other["attribution"].items():
        if set(cyc) != set(CATEGORIES):
            errs.append(f"channel {name}: categories {sorted(cyc)} != "
                        f"{sorted(CATEGORIES)}")
            continue
        total = other["horizons"].get(name)
        if total is None:
            errs.append(f"channel {name}: no recorded horizon")
        elif not math.isclose(sum(cyc.values()), total, abs_tol=1e-5):
            errs.append(f"channel {name}: attribution sums to "
                        f"{sum(cyc.values())}, horizon is {total}")
    return errs


# ---------------------------------------------------------------- roofline
@dataclasses.dataclass(frozen=True)
class RooflinePlacement:
    """One kernel or program placed on the roofline (paper §V context:
    which modeled term — compute, memory, collective — bounds it).

    ``terms`` maps bound name -> modeled seconds (or cycles; any one
    unit); ``ideal_s`` is the useful-FLOP time at peak, so
    ``roofline_frac`` is the attainable fraction of peak under the
    dominant bound."""
    name: str
    terms: Dict[str, float]
    ideal_s: float = 0.0

    @property
    def dominant(self) -> str:
        return max(self.terms, key=self.terms.get)

    @property
    def limit_s(self) -> float:
        return max(self.terms.values())

    @property
    def roofline_frac(self) -> float:
        return self.ideal_s / self.limit_s if self.limit_s else 0.0
