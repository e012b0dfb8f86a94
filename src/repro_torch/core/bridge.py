"""The FireBridge memory bridge (paper §IV, Fig. 3).

Host-side firmware sees "DDR" as plain arrays (idiomatic-C-style pointer
access in the paper; NumPy views here).  The accelerator side — the
hand-written CUDA kernel ("RTL sim"), its torch oracle ("golden model"), or
the deployment tier — accesses the same buffers through the bridge, which
logs every burst as a Transaction.  DDR buffers stay host numpy arrays; a
backend owns the copy to its device and back.  The SAME
firmware function runs unmodified against every backend; that is the
paper's equivalence guarantee, checked by core/equivalence.py.

Congestion is *online* (paper §IV-C): construct the bridge with a
``CongestionConfig`` and every device access and kernel burst list is
arbitrated through a shared ``LinkModel`` as the firmware runs, so
``bridge.time`` advances by modeled transfer latency and per-engine stall
statistics (Fig. 8) accumulate during ``launch()`` — no post-hoc replay
step.  Without a config the original fast path is preserved (one logical
cycle per access).

Fault injection is also online: construct the bridge with a ``FaultPlan``
(core/fuzz.py) and device-side bursts may be delayed/reordered/split, the
congestion config perturbed, and ``dev_read`` data transiently bit-flipped
behind an audited ECC-style retry — the paper's randomized memory bridge
(§IV).  Every injected fault is recorded in ``log.faults``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.congestion import (CongestionConfig, CongestionResult,
                                         LinkModel)
from repro_torch.core.counters import (CounterBank, CounterSpec,
                                       register_link_counters)
from repro_torch.core.registers import RegisterFile
from repro_torch.core.transactions import (BurstBatch, OpMark,
                                           TransactionLog, record_mark)


@dataclasses.dataclass
class Buffer:
    """One named DDR allocation (paper Fig. 3 "shared memory region")."""
    name: str
    addr: int
    array: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


class MemoryBridge:
    """Host DDR pool with transaction-logged accelerator access (§IV).

    With ``congestion`` set, device-side accesses route through the online
    ``LinkModel``: large transfers are split into ``max_burst_bytes``
    bursts, the link arbitrates them against every other engine's traffic,
    and ``self.time`` advances to the modeled completion time.  Host-side
    accesses (``host_read``/``host_write``) stay free — the paper's
    firmware dereferencing plain DDR pointers.
    """

    PAGE = 4096

    def __init__(self, log: Optional[TransactionLog] = None,
                 congestion: Optional[CongestionConfig] = None,
                 fault_plan: Optional["FaultPlan"] = None,
                 profile: bool = False) -> None:
        self.log = log if log is not None else TransactionLog()
        self._next = 0x1000_0000                    # DDR base
        self.buffers: Dict[str, Buffer] = {}
        self.time = 0.0
        self.fault_plan = fault_plan
        if fault_plan is not None and congestion is not None:
            congestion = fault_plan.perturb_congestion(congestion, self.log)
        self.congestion = congestion
        self.link: Optional[LinkModel] = (
            LinkModel(congestion) if congestion is not None else None)
        # data-movement profiling (core/profiler.py): with ``profile`` the
        # ``mark`` context manager attributes logged bursts to named ops.
        # Marks are metadata, not replayable state — deliberately excluded
        # from get_state/set_state.
        self.profile = profile
        self.marks: List[OpMark] = []
        # always-on sampled counters (core/counters.py, ROADMAP 5).
        # Probes only read state the bridge/link already maintain, so
        # timing and the transaction log are bit-identical with the bank
        # present — the golden traces are the witness.
        self.counters = CounterBank("ddr")
        self.counters.register(CounterSpec("transactions", "events"),
                               lambda: self.log.n_txs)
        if self.link is not None:
            register_link_counters(self.counters, self.link)
        else:
            self.counters.register(CounterSpec("bytes_moved", "bytes"))
            self.counters.register(CounterSpec("cycles", "cycles"),
                                   lambda: self.time)
        self.counters.register(CounterSpec("violations", "events"),
                               lambda: len(self.log.violations))
        self.counters.register(CounterSpec("faults", "events"),
                               lambda: len(self.log.faults))

    def mark(self, op: str, engine: str = "", meta: str = ""):
        """Attribute every transaction logged inside the block to one
        profiled op (core/profiler.py per-op timelines).  No-op unless the
        bridge was constructed with ``profile=True``, so the fast path
        stays mark-free."""
        if not self.profile:
            return contextlib.nullcontext()
        return record_mark(self.marks, self.log, lambda: self.time, op,
                           engine, meta)

    def alloc(self, name: str, shape, dtype) -> Buffer:
        """Reserve a page-aligned DDR region for ``name``."""
        if name in self.buffers:
            raise ValueError(
                f"buffer {name!r} already allocated at "
                f"{self.buffers[name].addr:#x}; re-alloc would silently "
                f"shadow it (free-list reuse is not modeled)")
        arr = np.zeros(shape, dtype)
        size = -(-arr.nbytes // self.PAGE) * self.PAGE
        buf = Buffer(name, self._next, arr)
        self._next += size
        self.buffers[name] = buf
        return buf

    # Firmware-side access: plain numpy (paper: dereferencing C pointers).
    def host_write(self, name: str, data) -> None:
        buf = self.buffers[name]
        arr = np.asarray(data, buf.array.dtype)
        if arr.shape != buf.array.shape:
            raise ValueError(
                f"host_write to {name!r}: data shape {arr.shape} != buffer "
                f"shape {buf.array.shape} (refusing silent broadcast)")
        np.copyto(buf.array, arr)

    def host_read(self, name: str) -> np.ndarray:
        return self.buffers[name].array.copy()

    # ------------------------------------------------ device-side access
    def _dev_bursts(self, buf: Buffer, kind: str, engine: str,
                    tag: str) -> BurstBatch:
        """Split one device transfer into link-level bursts (§IV-C) —
        built as a column batch, not per-burst Transaction objects."""
        step = self.congestion.max_burst_bytes if self.congestion else 0
        return BurstBatch.from_transfer(self.time, engine, kind, buf.addr,
                                        buf.nbytes, tag, step)

    def _submit(self, batch: BurstBatch) -> None:
        """Route one burst batch through the link (or the fast path),
        applying any fault-plan perturbation first."""
        if self.fault_plan is not None:
            batch = self.fault_plan.perturb_batch(batch, self.log)
        if self.link is not None:
            self.time = self.link.submit_batch(batch, self.log)
        else:
            self.time = self._fast_clock(batch, self.time)
        self.counters.tick(self.time)

    def _fast_clock(self, batch: BurstBatch, t: float) -> float:
        """Congestion-free logical clock over a batch: one cycle per
        burst; a delayed burst's min-issue time still holds.  Same
        float-op order as the per-object loop it replaces."""
        times = batch.rec["time"].tolist()
        out = [0.0] * len(times)
        for i, ti in enumerate(times):
            tn = t + 1
            t = tn if tn >= ti else ti
            out[i] = t
        if times:
            batch.rec["time"] = out
            self.log.log_batch(batch)
            self.counters.inc("bytes_moved", int(batch.rec["nbytes"].sum()))
        return t

    def dev_read(self, name: str, engine: str = "dma") -> np.ndarray:
        """Accelerator-side read: transaction-logged, congestion-timed.

        With a fault plan the returned data may suffer a transient bit
        flip; the bridge detects it (ECC-style), audits the fault, and
        re-issues the burst — the retry must heal, so firmware always sees
        clean data while the protocol path is exercised.
        """
        buf = self.buffers[name]
        self._submit(self._dev_bursts(buf, "read", engine, name))
        data = buf.array.copy()
        if (self.fault_plan is not None
                and self.fault_plan.flip_read(data, name, self.log)):
            # corrupted transfer detected against ECC: audited retry
            self._submit(self._dev_bursts(buf, "read", engine, name))
            data = buf.array.copy()
        return data

    def dev_write(self, name: str, data, engine: str = "dma") -> None:
        """Accelerator-side write: transaction-logged, congestion-timed."""
        buf = self.buffers[name]
        arr = np.asarray(data, buf.array.dtype)
        if arr.shape != buf.array.shape:
            raise ValueError(
                f"dev_write to {name!r}: data shape {arr.shape} != buffer "
                f"shape {buf.array.shape} (refusing silent broadcast)")
        self._submit(self._dev_bursts(buf, "write", engine, name))
        np.copyto(buf.array, arr)

    def log_burst_list(self, txs: List[Tuple[str, str, int, int]],
                       base_time: Optional[float] = None) -> None:
        """Log a kernel's static tile-schedule-derived burst list (see
        kernels/*/ops.transactions).

        With congestion enabled the whole list is arbitrated as one batch
        through the shared link — engines named in the list contend for
        bandwidth exactly as the paper's DMA VIPs do on the AXI fabric
        (Fig. 8) — and ``self.time`` advances to the batch makespan.
        """
        t = self.time if base_time is None else base_time
        batch = BurstBatch.from_tuples(t, txs)
        if self.fault_plan is not None:
            batch = self.fault_plan.perturb_batch(batch, self.log)
        if self.link is not None:
            self.time = self.link.submit_batch(batch, self.log)
        else:
            self.time = self._fast_clock(batch, t)
        self.counters.tick(self.time)

    def congestion_stats(self) -> Optional[CongestionResult]:
        """Fig. 8 statistics accumulated by the online link so far
        (None when the bridge runs congestion-free)."""
        return self.link.result() if self.link is not None else None

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        """Deep snapshot of the bridge at a transaction boundary
        (core/replay.py): DDR contents, the allocation cursor, the modeled
        clock, the online link arbiter, the fault-plan RNG position, and
        the transaction log.  Restoring it into a structurally identical
        bridge makes every subsequent access replay bit-identically."""
        return {
            "buffers": {n: (b.addr, b.array.copy())
                        for n, b in self.buffers.items()},
            "next": self._next,
            "time": self.time,
            "log": self.log.get_state(),
            "link": self.link.get_state() if self.link is not None else None,
            "fault_plan": (self.fault_plan.get_state()
                           if self.fault_plan is not None else None),
            "counters": self.counters.get_state(),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.buffers = {n: Buffer(n, addr, arr.copy())
                        for n, (addr, arr) in state["buffers"].items()}
        self._next = state["next"]
        self.time = state["time"]
        self.log.set_state(state["log"])
        if state["link"] is not None:
            self.link.set_state(state["link"])
        if state["fault_plan"] is not None:
            self.fault_plan.set_state(state["fault_plan"])
        cs = state.get("counters")
        if cs is not None:
            self.counters.set_state(cs)


class FireBridge:
    """Top-level co-verification environment: registers + memory bridge +
    switchable accelerator backends (paper Fig. 1c).

    Pass ``congestion`` to emulate interconnect contention online during
    ``launch()`` (§IV-C): stall statistics are then available from
    ``congestion_stats()`` as soon as the firmware returns.
    """

    BACKENDS = ("oracle", "interpret", "compiled")

    def __init__(self, name: str = "fb",
                 congestion: Optional[CongestionConfig] = None,
                 fault_plan: Optional["FaultPlan"] = None,
                 profile: bool = False) -> None:
        self.name = name
        self.log = TransactionLog()
        self.mem = MemoryBridge(self.log, congestion=congestion,
                                fault_plan=fault_plan, profile=profile)
        self.csr = RegisterFile(f"{name}.csr", self.log)
        self._ops: Dict[str, Dict[str, Callable]] = {}

    def register_op(self, name: str, *, oracle: Callable,
                    interpret: Optional[Callable] = None,
                    compiled: Optional[Callable] = None,
                    burst_list: Optional[Callable] = None) -> None:
        """An accelerator operation with up to three functionally-equivalent
        backends + an optional static burst-list derivation (the paper's
        golden-model / RTL-sim / deployment tiers, Fig. 1)."""
        self._ops[name] = {
            "oracle": oracle,
            "interpret": interpret or oracle,
            # callers pass an explicit deployment-tier fn for the compiled
            # backend; default falls back to the oracle.
            "compiled": compiled or oracle,
            "burst_list": burst_list,
        }

    def launch(self, op: str, backend: str, in_bufs: List[str],
               out_bufs: List[str], engine: str = "accel",
               burst_list: Optional[Callable] = None, **kw) -> None:
        """Run one accelerator op against named DDR buffers, logging the
        transaction stream (paper Fig. 3 launch path).

        ``burst_list`` (here or at register_op) derives the tile-level DMA
        bursts from the kernel's tile schedule; with congestion
        enabled those bursts contend on the shared link while the op runs,
        so per-engine stalls are produced by the launch itself (Fig. 8).
        """
        assert backend in self.BACKENDS, backend
        with self.mem.mark(f"{op}@{backend}", engine):
            self._launch(op, backend, in_bufs, out_bufs, engine,
                         burst_list, kw)

    def _launch(self, op: str, backend: str, in_bufs: List[str],
                out_bufs: List[str], engine: str,
                burst_list: Optional[Callable], kw: Dict) -> None:
        fns = self._ops[op]
        args = [self.mem.dev_read(n, engine=f"{engine}_rd") for n in in_bufs]
        bl = burst_list or fns["burst_list"]
        if bl is not None:
            self.mem.log_burst_list(bl())
        outs = fns[backend](*args, **kw)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(out_bufs):
            raise ValueError(
                f"op {op!r} ({backend}) returned {len(outs)} output(s) but "
                f"{len(out_bufs)} out_bufs were given ({out_bufs}); refusing "
                f"to silently truncate the writeback")
        for name, o in zip(out_bufs, outs):
            self.mem.dev_write(name, np.asarray(o), engine=f"{engine}_wr")

    def congestion_stats(self) -> Optional[CongestionResult]:
        """Per-engine stall/busy/utilization accumulated online (Fig. 8)."""
        return self.mem.congestion_stats()

    def counter_banks(self) -> List[CounterBank]:
        """Always-on counter banks owned by this target, in stable order
        (core/counters.py counter-diff oracle)."""
        return [self.mem.counters]

    def profiler(self, label: Optional[str] = None):
        """Off-chip data-movement profile of everything logged so far
        (core/profiler.py, §IV): exhaustive stall attribution closing to
        ``mem.time``, per-engine/per-op series, Perfetto export."""
        from repro_torch.core.profiler import DataMovementProfiler
        return DataMovementProfiler(self, label=label or self.name)

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        """Snapshot for time-travel replay (core/replay.py).  ``mem``
        carries the shared transaction log (``self.log`` is the same
        object), so CSR state is just values + the protocol clock."""
        return {"mem": self.mem.get_state(), "csr": self.csr.get_state()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.mem.set_state(state["mem"])
        self.csr.set_state(state["csr"])
