"""Time-travel replay & divergence-bisection debug engine (the paper's
headline 50x *debug iteration* speedup, §I/§V, made concrete).

Detecting a hardware/firmware divergence is cheap in this repo (golden
traces, equivalence groups, fuzz storms); *localizing* one used to mean a
full re-run from time zero.  FERIVer and ZynqParrot both showed that
checkpointed, window-scoped re-execution is what makes cycle-accurate
co-verification usable for debugging at scale — this module is that layer:

* **Timeline** — a ``DebugSession`` records a co-verification run as a
  deterministic sequence of ``TimelineEvent``s (bridge transactions,
  register-protocol accesses, serving scheduler ticks, fabric transfers —
  fault injections and congestion/link evolution ride along because they
  are functions of the replayed state).
* **Checkpoints** — at configurable transaction-boundary intervals the
  session snapshots FULL target state via the ``get_state``/``set_state``
  hooks grown on every stateful layer (bridge DDR + alloc cursor + clock,
  ``LinkModel`` arbiter + DoS RNG stream, ``FaultPlan`` RNG + event trace,
  CSR values + protocol clock, serving caches/slots/queues, every fabric
  port).
* **Window replay** — ``replay(rec, lo, hi)`` restores the nearest
  checkpoint at or before ``lo`` and re-executes events up to ``hi``.
  Because every RNG stream and clock is restored, the regenerated window
  is **bit-identical** to the original run — witnessed by
  ``TransactionLog.digest()``: a full-range replay rebuilds logs whose
  digests equal the original's exactly, and any window's canonical lines
  equal the recording's stored slice.
* **Bisection** — ``bisect_divergence(run_a, run_b)`` localizes the first
  divergent transaction between two recordings of the same timeline
  (e.g. oracle vs interpret, live vs last-known-good) WITHOUT a full
  re-run: it binary-searches the stored checkpoints (free probes — the
  snapshots are already in the recording), then replays only the one
  divergent window on each side and walks the two regenerated streams in
  lockstep.  Total cost: O(log N) probe comparisons + 2 window replays,
  comfortably inside the ``ceil(log2(N)) + 2`` replay budget the
  regression tests enforce by instrumentation (``DebugSession.replays``).

Two divergence modes are handled uniformly:

* **trace** divergence — the transaction streams differ (timing, order,
  addresses): first differing canonical line, named with its owning event.
* **state** divergence — the streams agree but DDR/CSR/token state
  differs (a wrong writeback value, the planted-bug case): checkpoints
  are compared by *functional fingerprint* (buffer contents, register
  values, request state — timing excluded, so legitimately
  timing-perturbed runs don't false-positive), and the lockstep window
  walk names the first event after which the fingerprints part.

Consumers: ``CoVerifySession`` attaches a ``DivergenceReport`` to failing
sweep cells, ``window_report`` replays the window around a trace mismatch
and prints surrounding device state, ``ProtocolFuzzer.shrink`` replays
candidate prefixes from the nearest checkpoint instead of re-executing
whole scenarios, and ``record_serving_storm`` records/replays
serving-engine storms.

This is the port of ``repro.core.replay``.  Recordings, windows and
digests are value-free and equal the reference's for the same program.
State fingerprints hash a tensor (a serving engine's cache, on whatever
device it lives) by dtype, shape and raw bytes, so a change of one element
anywhere in it changes the fingerprint.
"""
from __future__ import annotations

import bisect as _bisect
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bridge import FireBridge
from repro_torch.core.fabric import FabricCluster
from repro_torch.core.transactions import TransactionLog

__all__ = [
    "TimelineEvent", "Checkpoint", "OpTrace", "Recording", "ReplayWindow",
    "DebugSession", "Recorder", "RecordingBridge", "DivergenceReport",
    "bisect_divergence", "record_serving_storm", "serving_storm_program",
    "record_open_loop", "open_loop_program",
    "apply_event", "target_logs", "state_summary", "window_report",
]


def _hash_lines(lines: List[str]) -> str:
    """THE line-stream digest: one definition shared by recordings and
    replay windows, so the bit-identity contract
    (``ReplayWindow.digest() == Recording.window_digest(lo, hi)``) can
    never drift on formatting."""
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


# ---------------------------------------------------------------- timeline
@dataclasses.dataclass
class TimelineEvent:
    """One deterministic timeline op: a (kind, args) pair that
    ``apply_event`` can re-execute against a restored target.  Events live
    in memory for the session's lifetime — args may hold arrays and
    burst-list callables."""
    kind: str
    args: Tuple = ()

    def brief(self) -> str:
        """Short human rendering for divergence reports."""
        parts = []
        for a in self.args:
            if isinstance(a, np.ndarray):
                parts.append(f"ndarray{a.shape}")
            elif callable(a):
                parts.append("<fn>")
            elif isinstance(a, (dict, list, tuple)) and len(str(a)) > 40:
                parts.append(f"{type(a).__name__}[{len(a)}]")
            else:
                parts.append(repr(a))
        return f"{self.kind}({', '.join(parts)})"


@dataclasses.dataclass
class Checkpoint:
    """Full target state after ``op_index`` events (``get_state`` dict),
    plus two precomputed identities: ``fingerprint`` covers all
    architectural state (timing included, trace excluded) and
    ``func_fingerprint`` covers functional state only (buffers, CSR
    values, request/token state) — the bisection probe."""
    op_index: int
    state: Dict[str, Any]
    fingerprint: str
    func_fingerprint: str


@dataclasses.dataclass
class OpTrace:
    """One replayed event's observable footprint: the canonical lines it
    emitted, the functional fingerprint after it, and a small state
    summary for divergence reports."""
    op_index: int
    event: TimelineEvent
    lines: List[str]
    func_fingerprint: str
    summary: Dict[str, Any]


class Recording:
    """One recorded run: the event timeline, sparse full-state
    checkpoints, the per-op canonical-line stream, and the final
    digests.  ``replays`` counts how many window replays have been run
    against it — the instrumentation the bisection budget tests read."""

    def __init__(self, label: str, interval: int) -> None:
        self.label = label
        self.interval = interval
        self.events: List[TimelineEvent] = []
        self.checkpoints: List[Checkpoint] = []
        self.preamble: List[str] = []       # construction-time lines
        self.lines: List[str] = []          # op-emitted lines, in op order
        self.line_marks: List[int] = [0]    # lines after i ops (len n+1)
        # per-log cumulative transaction counts after i ops (len n+1 each)
        self.tx_marks: List[List[int]] = []
        self.log_digest = ""                # combined TransactionLog.digest()
        self.final_fingerprint = ""
        self.final_func_fingerprint = ""
        self.replays = 0
        # the live target as record() left it (state = op boundary n_ops);
        # replays build/restore their own target via the session factory
        self.target: Any = None

    @property
    def n_ops(self) -> int:
        return len(self.events)

    def digest(self) -> str:
        """sha256 over the full recorded line stream (preamble + ops)."""
        return _hash_lines(self.preamble + self.lines)

    def op_lines(self, i: int) -> List[str]:
        """Canonical lines emitted by event ``i``."""
        return self.lines[self.line_marks[i]:self.line_marks[i + 1]]

    def window_lines(self, lo: int, hi: int) -> List[str]:
        """Canonical lines emitted by events ``[lo, hi)`` — what a replay
        of that window must reproduce bit-identically."""
        return self.lines[self.line_marks[lo]:self.line_marks[hi]]

    def window_digest(self, lo: int, hi: int) -> str:
        return _hash_lines(self.window_lines(lo, hi))

    def nearest_checkpoint(self, op: int) -> Checkpoint:
        """Last checkpoint at or before op boundary ``op`` (checkpoint 0
        always exists — the freshly constructed target)."""
        best = self.checkpoints[0]
        for ck in self.checkpoints:
            if ck.op_index <= op:
                best = ck
        return best

    def op_of_tx(self, log_index: int, tx_index: int) -> int:
        """Map transaction ``tx_index`` of log ``log_index`` to the event
        that emitted it (-1 = emitted during target construction)."""
        marks = self.tx_marks[log_index]
        if tx_index < marks[0]:
            return -1
        return min(_bisect.bisect_right(marks, tx_index) - 1,
                   self.n_ops - 1)


@dataclasses.dataclass
class ReplayWindow:
    """Outcome of one window replay: per-op traces for ``[lo, hi)`` and
    the live target left at state ``hi`` (ready for inspection)."""
    lo: int
    hi: int
    ops: List[OpTrace]
    target: Any
    from_checkpoint: int

    @property
    def lines(self) -> List[str]:
        return [ln for t in self.ops for ln in t.lines]

    def digest(self) -> str:
        return _hash_lines(self.lines)


# ------------------------------------------------------- state inspection
def _is_cluster_serving(target: Any) -> bool:
    return hasattr(target, "engines") and hasattr(target, "csr")


def _is_serving(target: Any) -> bool:
    return hasattr(target, "slots") and hasattr(target, "step")


def target_logs(target: Any) -> List[TransactionLog]:
    """The target's transaction logs in canonical order (the order golden
    trace files concatenate them)."""
    if isinstance(target, FireBridge):
        return [target.log]
    if isinstance(target, FabricCluster):
        return [target.log] + [d.log for d in target.devices]
    if _is_cluster_serving(target):
        return [target.log] + [e.mem.log for e in target.engines]
    if _is_serving(target):
        return [target.mem.log]
    raise TypeError(f"no replay log mapping for {type(target).__name__}")


def _hash_update(h: "hashlib._Hash", v: Any) -> None:
    if isinstance(v, torch.Tensor):
        # raw bytes, not repr (which elides the middle of a large tensor)
        # and not numpy (which has no bfloat16)
        h.update(f"pt{tuple(v.shape)}{v.dtype}".encode())
        h.update(v.detach().contiguous().reshape(-1).cpu()
                 .view(torch.uint8).numpy().tobytes())
    elif isinstance(v, np.ndarray):
        h.update(f"nd{v.shape}{v.dtype}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, (bytes, bytearray)):
        h.update(bytes(v))
    elif isinstance(v, float):
        h.update(np.float64(v).tobytes())
    elif isinstance(v, dict):
        for k in sorted(v, key=str):
            h.update(str(k).encode())
            _hash_update(h, v[k])
    elif isinstance(v, (list, tuple)):
        for x in v:
            _hash_update(h, x)
    elif isinstance(v, (set, frozenset)):
        for x in sorted(repr(y) for y in v):
            h.update(x.encode())
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            h.update(f.name.encode())
            _hash_update(h, getattr(v, f.name))
    elif hasattr(v, "tobytes"):            # np scalars
        h.update(np.asarray(v).tobytes())
    else:
        h.update(repr(v).encode())


# state-dict keys that are trace/history, never replay-relevant identity
# ("counters" is the sampled CounterBank stream — derived observation of
# the other state, bit-identically regenerated by replay, so including it
# would only double-count what the log/timing keys already witness)
_TRACE_KEYS = frozenset({"log", "timeline", "counters"})
# additionally excluded from the FUNCTIONAL fingerprint: anything timing-
# or stimulus-stream-shaped, so runs that legitimately differ in timing
# (per-backend fault forks, perturbed congestion) only diverge
# functionally when data actually differs
_TIMING_KEYS = _TRACE_KEYS | frozenset({
    "time", "link", "host_link", "ports", "switch", "rng", "fault_plan",
    "link_plan", "next", "rr", "written", "clock"})
# keys whose subtrees hold USER data (buffer names, register addresses,
# request ids) — exclusion must stop at their boundary, or a buffer that
# happens to be named "time"/"link" would silently vanish from every
# fingerprint
_DATA_KEYS = frozenset({"buffers", "vals", "cache", "requests", "slots",
                        "pending", "placement"})


def _fingerprint(state: Dict[str, Any], exclude: frozenset) -> str:
    h = hashlib.sha256()

    def walk(v: Any, structural: bool) -> None:
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                if structural and str(k) in exclude:
                    continue
                h.update(str(k).encode())
                walk(v[k], structural and str(k) not in _DATA_KEYS)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x, structural)
        else:
            _hash_update(h, v)

    walk(state, True)
    return h.hexdigest()


def state_fingerprint(state: Dict[str, Any]) -> str:
    """Architectural identity of a ``get_state`` snapshot (trace history
    excluded; clocks, RNG streams, and data all included)."""
    return _fingerprint(state, _TRACE_KEYS)


def functional_fingerprint(state: Dict[str, Any]) -> str:
    """Functional identity only: DDR/buffer contents, CSR values, request
    and token state.  Timing, RNG streams, and logs excluded — the
    bisection probe for data divergences under timing-perturbed runs."""
    return _fingerprint(state, _TIMING_KEYS)


def state_summary(target: Any) -> Dict[str, Any]:
    """Small human-facing excerpt of the target's architectural state —
    what a divergence report prints as "surrounding device state"."""
    def bufs(mem, prefix=""):
        return {f"{prefix}{n}": hashlib.sha256(
                    np.ascontiguousarray(b.array).tobytes()).hexdigest()[:12]
                for n, b in sorted(mem.buffers.items())}

    if isinstance(target, FireBridge):
        return {"time": round(target.mem.time, 6),
                "buffers": bufs(target.mem),
                "csr": {r.name: target.csr.hw_get(r.name)
                        for r in target.csr._by_addr.values()},
                "faults": len(target.log.faults),
                "violations": len(target.log.violations)}
    if isinstance(target, FabricCluster):
        out = {"time": round(target.time, 6), "buffers": bufs(target.host,
                                                             "host/")}
        for i, d in enumerate(target.devices):
            out["buffers"].update(bufs(d.mem, f"d{i}/"))
        out["violations"] = len(target.violations)
        return out
    if _is_cluster_serving(target):
        out = {"time": round(target.time, 6), "buffers": bufs(target.mem),
               "completed": target.completed,
               "tokens": {rid: list(r.out_tokens)
                          for rid, r in sorted(target.requests.items())},
               "violations": len(target.violations)}
        pools = {f"e{i}": e.kv_pool.n_free
                 for i, e in enumerate(target.engines)
                 if getattr(e, "kv_pool", None) is not None}
        if pools:
            out["kv_free_pages"] = pools
        return out
    if _is_serving(target):
        out = {"time": round(target.mem.time, 6),
               "buffers": bufs(target.mem),
               "completed": target.completed,
               "tokens": {rid: list(r.out_tokens)
                          for rid, r in sorted(target.requests.items())},
               "violations": len(target.mem.log.violations)}
        if getattr(target, "kv_pool", None) is not None:
            out["kv_free_pages"] = {"e0": target.kv_pool.n_free}
        return out
    raise TypeError(f"no replay summary for {type(target).__name__}")


# --------------------------------------------------------- event execution
def _apply_bridge(fb: FireBridge, ev: TimelineEvent) -> Any:
    k, a = ev.kind, ev.args
    if k == "alloc":
        return fb.mem.alloc(a[0], a[1], a[2])
    if k == "host_write":
        return fb.mem.host_write(a[0], a[1])
    if k == "host_read":
        return fb.mem.host_read(a[0])
    if k == "dev_read":
        return fb.mem.dev_read(a[0], engine=a[1])
    if k == "dev_write":
        return fb.mem.dev_write(a[0], a[1], engine=a[2])
    if k == "log_burst_list":
        return fb.mem.log_burst_list(list(a[0]), base_time=a[1])
    if k == "launch":
        op, backend, in_bufs, out_bufs, engine, burst_list, kw = a
        return fb.launch(op, backend, list(in_bufs), list(out_bufs),
                         engine=engine, burst_list=burst_list, **kw)
    if k == "csr_write":
        return fb.csr.fb_write_32(a[0], a[1])
    if k == "csr_read":
        return fb.csr.fb_read_32(a[0])
    if k == "poll":
        return fb.csr.poll(a[0], a[1], a[2], max_reads=a[3],
                           strict=a[4] if len(a) > 4 else False)
    raise ValueError(f"unknown bridge event kind {k!r}")


def _apply_fabric(fab: FabricCluster, ev: TimelineEvent) -> Any:
    k, a = ev.kind, ev.args
    if k == "host_alloc":
        return fab.host.alloc(a[0], a[1], a[2])
    if k == "host_write":
        return fab.host.host_write(a[0], a[1])
    if k == "dev_alloc":
        return fab.devices[a[0]].mem.alloc(a[1], a[2], a[3])
    if k == "dev_host_write":
        return fab.devices[a[0]].mem.host_write(a[1], a[2])
    if k == "alloc_sharded":
        return fab.alloc_sharded(a[0], a[1], a[2], axis=a[3])
    if k == "scatter":
        return fab.scatter(a[0], axis=a[1])
    if k == "broadcast":
        return fab.broadcast(a[0])
    if k == "gather":
        return fab.gather(a[0], axis=a[1])
    if k == "all_reduce":
        return fab.all_reduce(a[0], op=a[1])
    if k == "dev_copy":
        return fab.dev_copy(a[0], a[1], a[2], dst_name=a[3])
    if k == "collect_replicated":
        return fab.collect_replicated(a[0])
    if k == "launch":
        dev, op, backend, in_bufs, out_bufs, kw = a
        return fab.launch(dev, op, backend, list(in_bufs), list(out_bufs),
                          **kw)
    raise ValueError(f"unknown fabric event kind {k!r}")


def _apply_serving(eng: Any, ev: TimelineEvent) -> Any:
    k, a = ev.kind, ev.args
    if k == "host_poke":
        data = np.asarray(a[1])
        eng.mem.buffers[a[0]].array[:data.size] = data
        return None
    if k == "csr_write":
        return eng.csr.fb_write_32(eng.csr.addr_of(a[0]), a[1])
    if k == "csr_read":
        return eng.csr.fb_read_32(eng.csr.addr_of(a[0]))
    if k == "poll":
        return eng.csr.poll(a[0], a[1], a[2], max_reads=a[3],
                            strict=a[4] if len(a) > 4 else False)
    if k == "step":
        return eng.step()
    if k == "advance":
        return eng.advance_clock(a[0])
    raise ValueError(f"unknown serving event kind {k!r}")


def apply_event(target: Any, ev: TimelineEvent) -> Any:
    """Execute ONE timeline event against a live target.  Record and
    replay both funnel through here, so the two cannot drift."""
    if ev.kind == "call":                  # escape hatch: fn(target, *args)
        return ev.args[0](target, *ev.args[1:])
    if isinstance(target, FireBridge):
        return _apply_bridge(target, ev)
    if isinstance(target, FabricCluster):
        return _apply_fabric(target, ev)
    if _is_cluster_serving(target) or _is_serving(target):
        return _apply_serving(target, ev)
    raise TypeError(f"no replay apply for {type(target).__name__}")


# ------------------------------------------------------------- the session
class Recorder:
    """Handed to a recording program: ``do(kind, *args)`` executes one
    event against the live target AND appends it to the recording (with
    line/tx attribution and interval checkpointing).  ``checkpoint()``
    forces a transaction-boundary checkpoint right now."""

    def __init__(self, session: "DebugSession", target: Any,
                 rec: Recording) -> None:
        self.session = session
        self.target = target
        self.rec = rec
        self.logs = target_logs(target)
        self._cursors = [log.cursor() for log in self.logs]
        # construction-time lines (e.g. congestion_perturb at bridge init)
        for log in self.logs:
            rec.preamble.extend(log.lines_since((0, 0, 0)))
        rec.tx_marks = [[log.n_txs] for log in self.logs]
        self.checkpoint()

    def do(self, kind: str, *args: Any) -> Any:
        ev = TimelineEvent(kind, args)
        out = self.session.apply(self.target, ev)
        self.session.ops_applied += 1
        self.rec.events.append(ev)
        for li, log in enumerate(self.logs):
            self.rec.lines.extend(log.lines_since(self._cursors[li]))
            self._cursors[li] = log.cursor()
            self.rec.tx_marks[li].append(log.n_txs)
        self.rec.line_marks.append(len(self.rec.lines))
        n = self.rec.n_ops
        if self.session.interval and n % self.session.interval == 0:
            self.checkpoint()
        return out

    def checkpoint(self) -> Checkpoint:
        n = self.rec.n_ops
        if self.rec.checkpoints and self.rec.checkpoints[-1].op_index == n:
            return self.rec.checkpoints[-1]
        state = self.target.get_state()
        ck = Checkpoint(n, state, state_fingerprint(state),
                        functional_fingerprint(state))
        self.rec.checkpoints.append(ck)
        return ck


class DebugSession:
    """Record a deterministic co-verification run; replay any window of it
    bit-identically.

    ``factory()`` builds a structurally complete target (ops registered,
    CSRs defined, congestion/fault plan installed from their seeds) in its
    INITIAL state; ``apply(target, event)`` executes one timeline event
    (default: ``apply_event``).  ``checkpoint_interval`` is the op count
    between automatic full-state snapshots (0 = only the initial one and
    explicit ``Recorder.checkpoint()`` calls).

    ``replays`` / ``ops_applied`` are instrumentation counters: the
    bisection budget tests assert on the former, the shrink/benchmark
    economics on the latter.
    """

    def __init__(self, factory: Callable[[], Any],
                 apply: Optional[Callable[[Any, TimelineEvent], Any]] = None,
                 checkpoint_interval: int = 8,
                 label: str = "run") -> None:
        self.factory = factory
        self.apply = apply or apply_event
        self.interval = checkpoint_interval
        self.label = label
        self.replays = 0
        self.ops_applied = 0

    # ----------------------------------------------------------- recording
    def record(self, program: Any) -> Recording:
        """Run ``program`` against a fresh target, recording the timeline.

        ``program`` is either a callable taking the ``Recorder`` (drive
        events via ``rec.do``/``rec.checkpoint``; ``rec.target`` is the
        live object for read-only inspection) or a plain sequence of
        ``TimelineEvent``s / ``(kind, *args)`` tuples.
        """
        target = self.factory()
        rec = Recording(self.label, self.interval)
        recorder = Recorder(self, target, rec)
        if callable(program):
            program(recorder)
        else:
            for ev in program:
                if isinstance(ev, TimelineEvent):
                    recorder.do(ev.kind, *ev.args)
                else:
                    recorder.do(ev[0], *ev[1:])
        final = recorder.checkpoint()
        rec.final_fingerprint = final.fingerprint
        rec.final_func_fingerprint = final.func_fingerprint
        h = hashlib.sha256()
        for log in recorder.logs:
            h.update(log.digest().encode())
        rec.log_digest = h.hexdigest()
        rec.target = target
        return rec

    # ------------------------------------------------------------- replay
    def replay(self, rec: Recording, lo: int, hi: int) -> ReplayWindow:
        """Re-execute events ``[lo, hi)`` from the nearest checkpoint at
        or before ``lo``; returns per-op traces plus the live target left
        at op boundary ``hi``.  ``lo == hi`` replays nothing but still
        materializes the target's state at that boundary (the prefix-
        restore primitive the fuzz shrinker uses).  Bit-identity contract:
        ``ReplayWindow.lines == rec.window_lines(lo, hi)``.
        """
        if not (0 <= lo <= hi <= rec.n_ops):
            raise ValueError(f"window [{lo}, {hi}) outside "
                             f"[0, {rec.n_ops}]")
        ck = rec.nearest_checkpoint(lo)
        target = self.factory()
        target.set_state(ck.state)
        self.replays += 1
        rec.replays += 1
        logs = target_logs(target)
        cursors = [log.cursor() for log in logs]
        ops: List[OpTrace] = []
        for i in range(ck.op_index, hi):
            ev = rec.events[i]
            self.apply(target, ev)
            self.ops_applied += 1
            lines: List[str] = []
            for li, log in enumerate(logs):
                lines.extend(log.lines_since(cursors[li]))
                cursors[li] = log.cursor()
            if i >= lo:
                state = target.get_state()
                ops.append(OpTrace(i, ev, lines,
                                   functional_fingerprint(state),
                                   state_summary(target)))
        return ReplayWindow(lo, hi, ops, target, ck.op_index)


# -------------------------------------------------------- firmware tracing
class _RecordingMem:
    """Memory-bridge facade that records every state-mutating call as a
    timeline event (reads of ``buffers`` pass through untouched)."""

    def __init__(self, rec: Recorder) -> None:
        self._rec = rec

    def alloc(self, name, shape, dtype):
        return self._rec.do("alloc", name, shape, dtype)

    def host_write(self, name, data):
        return self._rec.do("host_write", name, np.asarray(data).copy())

    def host_read(self, name):
        return self._rec.do("host_read", name)

    def dev_read(self, name, engine="dma"):
        return self._rec.do("dev_read", name, engine)

    def dev_write(self, name, data, engine="dma"):
        return self._rec.do("dev_write", name, np.asarray(data).copy(),
                            engine)

    def log_burst_list(self, txs, base_time=None):
        return self._rec.do("log_burst_list", list(txs), base_time)

    def __getattr__(self, attr):
        return getattr(self._rec.target.mem, attr)


class _RecordingCsr:
    """CSR facade: protocol accesses become timeline events; map queries
    (``addr_of``, ``hw_get``) pass through."""

    def __init__(self, rec: Recorder) -> None:
        self._rec = rec

    def fb_write_32(self, addr, data):
        return self._rec.do("csr_write", addr, data)

    def fb_read_32(self, addr):
        return self._rec.do("csr_read", addr)

    def poll(self, name, mask, value, max_reads=10_000, strict=False):
        return self._rec.do("poll", name, mask, value, max_reads, strict)

    def __getattr__(self, attr):
        return getattr(self._rec.target.csr, attr)


class RecordingBridge:
    """FireBridge facade for recording an OPAQUE firmware callable: hand
    this to ``firmware(fb, op, backend, **config)`` instead of the bridge
    and every bridge-level call it makes lands on the timeline — the hook
    ``CoVerifySession`` uses to turn a failing sweep cell into a
    replayable recording without changing the firmware."""

    def __init__(self, rec: Recorder) -> None:
        self._rec = rec
        self._mem = _RecordingMem(rec)
        self._csr = _RecordingCsr(rec)

    @property
    def mem(self):
        return self._mem

    @property
    def csr(self):
        return self._csr

    def launch(self, op, backend, in_bufs, out_bufs, engine="accel",
               burst_list=None, **kw):
        return self._rec.do("launch", op, backend, tuple(in_bufs),
                            tuple(out_bufs), engine, burst_list, dict(kw))

    def __getattr__(self, attr):
        return getattr(self._rec.target, attr)


# ------------------------------------------------------------ serving storm
def serving_storm_program(reqs: Sequence[Tuple[int, Sequence[int], int]],
                          max_ticks: int = 10_000) -> Callable:
    """Build a recording program for a serving storm: each request is a
    ``(rid, prompt, max_new_tokens)`` triple driven through the CSR
    protocol (prompt poke, SUBMIT_*, DOORBELL — one checkpoint per
    submission), then scheduler ticks until drained."""

    def program(rec: Recorder) -> None:
        eng = rec.target
        for rid, prompt, mx in reqs:
            rec.do("host_poke", "prompt_in", np.asarray(prompt, np.int32))
            rec.do("csr_write", "SUBMIT_ID", int(rid))
            rec.do("csr_write", "SUBMIT_LEN", len(prompt))
            rec.do("csr_write", "SUBMIT_MAXNEW", int(mx))
            rec.do("csr_write", "DOORBELL", 1)
            rec.checkpoint()
        pending = (eng._n_pending if _is_cluster_serving(eng)
                   else lambda: len(eng.pending))
        for _ in range(max_ticks):
            if not pending() and not eng._n_active():
                break
            rec.do("step")

    return program


def record_serving_storm(session: DebugSession,
                         reqs: Sequence[Tuple[int, Sequence[int], int]],
                         max_ticks: int = 10_000) -> Recording:
    """Record a serving storm (single engine or cluster — same CSR
    surface) as a replayable timeline."""
    return session.record(serving_storm_program(reqs, max_ticks))


def open_loop_program(trace: Any, max_ticks: int = 200_000) -> Callable:
    """Build a recording program for an open-loop serving run: the
    arrival trace is driven through ``serving.arrivals.drive_open_loop``
    — the SAME decision loop the live driver uses, with ``rec.do`` as the
    event sink — so a recorded run and a live run of one trace emit
    identical timelines (submissions, idle-gap ``advance`` events,
    scheduler ticks)."""
    from repro_torch.serving.arrivals import drive_open_loop

    def program(rec: Recorder) -> None:
        drive_open_loop(rec.do, rec.target, trace, max_ticks)
        rec.checkpoint()

    return program


def record_open_loop(session: DebugSession, trace: Any,
                     max_ticks: int = 200_000) -> Recording:
    """Record an open-loop serving run (single engine or cluster in
    continuous-batching mode) as a replayable timeline."""
    return session.record(open_loop_program(trace, max_ticks))


# ---------------------------------------------------------------- bisection
@dataclasses.dataclass
class DivergenceReport:
    """Where two runs of one timeline first part ways.

    ``kind`` is "trace" (the transaction streams differ — ``line_a`` /
    ``line_b`` hold the first differing canonical lines) or "state" (the
    streams agree but functional state diverged — ``detail`` names the
    first differing leaf).  ``op_index``/``event`` name the divergent
    transaction-boundary op; ``state_a``/``state_b`` are the device-state
    summaries right after it; ``n_replays`` is the instrumented window-
    replay count this localization consumed.
    """
    label_a: str
    label_b: str
    kind: str
    op_index: int
    event: str
    line_index: Optional[int]
    line_a: Optional[str]
    line_b: Optional[str]
    detail: str
    window: Tuple[int, int]
    n_replays: int
    context_a: List[str]
    context_b: List[str]
    state_a: Dict[str, Any]
    state_b: Dict[str, Any]

    def render(self) -> str:
        out = [f"divergence: {self.label_a} vs {self.label_b}",
               f"  first divergent op: #{self.op_index} {self.event} "
               f"({self.kind} divergence)",
               f"  localized via window replay [{self.window[0]}, "
               f"{self.window[1]}) in {self.n_replays} replay(s)"]
        if self.kind == "trace":
            out += [f"  line {self.line_index}:",
                    f"    {self.label_a}: {self.line_a}",
                    f"    {self.label_b}: {self.line_b}"]
        else:
            out.append(f"  {self.detail}")
        if self.context_a:
            out.append(f"  replayed window ({self.label_a}):")
            out += [f"    {ln}" for ln in self.context_a[-6:]]
        out.append(f"  device state after op ({self.label_a} | "
                   f"{self.label_b}):")
        for k in sorted(set(self.state_a) | set(self.state_b)):
            va, vb = self.state_a.get(k), self.state_b.get(k)
            mark = " " if va == vb else "*"
            out.append(f"   {mark}{k}: {va!r} | {vb!r}")
        return "\n".join(out)

    def save(self, path) -> None:
        """Write the rendered report + full replayed window as a debug
        bundle (what CI uploads on tier-1 failure)."""
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        body = [self.render(), "", f"window lines ({self.label_a}):"]
        body += self.context_a
        body += ["", f"window lines ({self.label_b}):"]
        body += self.context_b
        p.write_text("\n".join(body) + "\n")


def _first_diff(a: List[str], b: List[str]) -> Optional[int]:
    for i in range(min(len(a), len(b))):
        if a[i] != b[i]:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _state_diff_note(sa: Dict[str, Any], sb: Dict[str, Any]) -> str:
    for k in sorted(set(sa) | set(sb)):
        va, vb = sa.get(k), sb.get(k)
        if isinstance(va, dict) and isinstance(vb, dict):
            for kk in sorted(set(va) | set(vb)):
                if va.get(kk) != vb.get(kk):
                    return (f"first differing state leaf: {k}/{kk} = "
                            f"{va.get(kk)!r} vs {vb.get(kk)!r}")
        elif va != vb:
            return f"first differing state leaf: {k} = {va!r} vs {vb!r}"
    return "states differ (fingerprint level)"


def bisect_divergence(session_a: DebugSession, rec_a: Recording,
                      session_b: DebugSession, rec_b: Recording
                      ) -> Optional[DivergenceReport]:
    """Localize the first divergent transaction between two recordings of
    the same timeline in O(log N) checkpoint probes + 2 window replays.

    Checkpoint probes compare the stored functional fingerprints (binary
    search — no re-execution); the per-op line streams give the trace
    candidate for free.  Only the ONE divergent window is then replayed on
    each side, and the two regenerated streams are walked in lockstep to
    name the first event whose emitted lines or functional state differ.
    Returns None when the runs are identical.

    Requires both recordings to cover the same op timeline (same event
    count and checkpoint schedule) — the supported debug scenarios record
    the same firmware/program against two configurations.
    """
    n = min(rec_a.n_ops, rec_b.n_ops)
    base_replays = rec_a.replays + rec_b.replays

    # ---- construction-time divergence (different fault-plan forks /
    # perturbed configs): the streams part before the first op — report
    # the preamble line diff directly, with op-0 state for context
    if rec_a.preamble != rec_b.preamble:
        d = _first_diff(rec_a.preamble, rec_b.preamble)
        wa = session_a.replay(rec_a, 0, min(1, n))
        wb = session_b.replay(rec_b, 0, min(1, n))
        pick = lambda p: p[d] if d < len(p) else "<stream ended>"
        return DivergenceReport(
            rec_a.label, rec_b.label, "preamble", 0,
            rec_a.events[0].brief() if n else "<construction>", d,
            pick(rec_a.preamble), pick(rec_b.preamble),
            "construction-time divergence (fault-plan fork / perturbed "
            "config) precedes the first timeline op", (0, min(1, n)),
            rec_a.replays + rec_b.replays - base_replays,
            wa.lines, wb.lines,
            wa.ops[-1].summary if wa.ops else {},
            wb.ops[-1].summary if wb.ops else {})

    # ---- trace candidate: first op whose emitted lines differ (free)
    trace_op: Optional[int] = None
    for i in range(n):
        if rec_a.op_lines(i) != rec_b.op_lines(i):
            trace_op = i
            break

    # ---- state candidate: binary-search the COMMON stored checkpoints
    # (free probes — snapshots already in the recordings) for the first
    # functional-fingerprint divergence
    a_by_op = {c.op_index: c for c in rec_a.checkpoints if c.op_index <= n}
    b_by_op = {c.op_index: c for c in rec_b.checkpoints if c.op_index <= n}
    common = sorted(set(a_by_op) & set(b_by_op))    # 0 is always present

    def fp_differs(op: int) -> bool:
        return (a_by_op[op].func_fingerprint
                != b_by_op[op].func_fingerprint)

    state_window: Optional[Tuple[int, int]] = None
    if common:
        if fp_differs(common[0]):
            state_window = (0, max(common[0], 1))
        elif fp_differs(common[-1]):
            lo_i, hi_i = 0, len(common) - 1     # invariant: lo ==, hi !=
            while hi_i - lo_i > 1:
                mid = (lo_i + hi_i) // 2
                if fp_differs(common[mid]):
                    hi_i = mid
                else:
                    lo_i = mid
            state_window = (common[lo_i], common[hi_i])
        elif rec_a.final_func_fingerprint != rec_b.final_func_fingerprint:
            state_window = (common[-1], n)      # un-checkpointed tail

    # ---- choose the earliest divergent window.  A state divergence is
    # only known to lie somewhere in (state_lo, state_hi]; if the first
    # trace difference sits beyond state_lo, the true first divergence
    # may be a silent state change before it — so the window must open
    # at state_lo and close at the trace candidate (the lockstep walk
    # checks both lines and fingerprints, whichever comes first wins).
    if trace_op is None and state_window is None:
        if (rec_a.digest() == rec_b.digest()
                and rec_a.final_func_fingerprint
                == rec_b.final_func_fingerprint
                and rec_a.n_ops == rec_b.n_ops):
            return None
        # length mismatch beyond the common prefix
        lo = max((op for op in common if op <= n), default=0)
        hi = n
    elif trace_op is not None and (state_window is None
                                   or trace_op <= state_window[0]):
        lo = rec_a.nearest_checkpoint(trace_op).op_index
        hi = min(trace_op + 1, n)
    elif trace_op is not None:
        lo = state_window[0]
        hi = min(state_window[1], trace_op + 1)
    else:
        lo, hi = state_window

    # ---- replay ONLY the divergent window, once per run (2 replays)
    wa = session_a.replay(rec_a, lo, hi)
    wb = session_b.replay(rec_b, lo, hi)

    report: Optional[DivergenceReport] = None
    for ta, tb in zip(wa.ops, wb.ops):
        d = _first_diff(ta.lines, tb.lines)
        if d is not None:
            report = DivergenceReport(
                rec_a.label, rec_b.label, "trace", ta.op_index,
                ta.event.brief(),
                len(rec_a.preamble) + rec_a.line_marks[ta.op_index] + d,
                ta.lines[d] if d < len(ta.lines) else "<stream ended>",
                tb.lines[d] if d < len(tb.lines) else "<stream ended>",
                "", (lo, hi), 0, [], [], ta.summary, tb.summary)
            break
        if ta.func_fingerprint != tb.func_fingerprint:
            report = DivergenceReport(
                rec_a.label, rec_b.label, "state", ta.op_index,
                ta.event.brief(), None, None, None,
                _state_diff_note(ta.summary, tb.summary),
                (lo, hi), 0, [], [], ta.summary, tb.summary)
            break
    if report is None and rec_a.n_ops != rec_b.n_ops:
        i = min(rec_a.n_ops, rec_b.n_ops)
        longer = rec_a if rec_a.n_ops > rec_b.n_ops else rec_b
        report = DivergenceReport(
            rec_a.label, rec_b.label, "length", i,
            longer.events[i].brief() if i < longer.n_ops else "<end>",
            None, None, None,
            f"timelines diverge in length: {rec_a.n_ops} vs "
            f"{rec_b.n_ops} ops", (lo, hi), 0, [], [],
            wa.ops[-1].summary if wa.ops else {},
            wb.ops[-1].summary if wb.ops else {})
    if report is None:
        # defensive: the chosen window showed nothing observable (e.g. a
        # divergence the functional probe abstracts away) — linear-scan
        # the common-checkpoint windows end to end
        cks = common if common else [0]
        if cks[-1] != n:
            cks = cks + [n]
        for j in range(len(cks) - 1):
            wa = session_a.replay(rec_a, cks[j], cks[j + 1])
            wb = session_b.replay(rec_b, cks[j], cks[j + 1])
            for ta, tb in zip(wa.ops, wb.ops):
                if (ta.lines != tb.lines
                        or ta.func_fingerprint != tb.func_fingerprint):
                    d = _first_diff(ta.lines, tb.lines)
                    report = DivergenceReport(
                        rec_a.label, rec_b.label,
                        "trace" if d is not None else "state",
                        ta.op_index, ta.event.brief(), None,
                        None if d is None else ta.lines[d:d + 1][0]
                        if d < len(ta.lines) else "<stream ended>",
                        None if d is None else tb.lines[d:d + 1][0]
                        if d < len(tb.lines) else "<stream ended>",
                        _state_diff_note(ta.summary, tb.summary),
                        (cks[j], cks[j + 1]), 0, [], [],
                        ta.summary, tb.summary)
                    break
            if report is not None:
                break
        if report is None:
            return None
    report.context_a = wa.lines
    report.context_b = wb.lines
    report.n_replays = (rec_a.replays + rec_b.replays) - base_replays
    return report


def window_report(session: DebugSession, rec: Recording, op_index: int,
                  context: int = 2) -> str:
    """Replay the window around one op and render its transactions plus
    the device state right after it — what the golden-trace tests print
    when a committed trace diverges."""
    lo = max(0, op_index - context)
    hi = min(rec.n_ops, op_index + context + 1)
    w = session.replay(rec, lo, hi)
    out = [f"replayed window [{lo}, {hi}) of {rec.label!r} "
           f"(from checkpoint @op {w.from_checkpoint}):"]
    for t in w.ops:
        mark = ">>" if t.op_index == op_index else "  "
        out.append(f"{mark} op #{t.op_index}: {t.event.brief()}")
        out += [f"     {ln}" for ln in t.lines]
        if t.op_index == op_index:
            out.append("     device state after op:")
            for k, v in sorted(t.summary.items()):
                out.append(f"       {k}: {v!r}")
    return "\n".join(out)
