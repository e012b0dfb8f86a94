"""Batched multi-backend co-verification scheduler (paper §V / Fig. 5).

One debug iteration in the paper is: edit firmware, re-simulate, re-check
equivalence.  At sweep scale — many ops x backends x configs — running
those iterations one at a time leaves the simulator idle while Python sets
up the next cell and recompiles backends it has already compiled.  The
``CoVerifySession`` scheduler batches the sweep:

* a sweep **cell** is one ``(op, backend, config)`` triple, executed as
  firmware against a fresh ``FireBridge`` (optionally with the online
  congestion link, §IV-C);
* backend callables are registered **once per session** and shared across
  every cell, so compiled executables are cached across the sweep
  instead of re-traced per iteration (the FireSim-style "build once, run
  many" economy);
* independent cells run **concurrently** on a thread pool — the CUDA
  kernels (launched through ``ctypes``), torch ops and NumPy release the
  GIL while they compute, so oracle/interpret/compiled cells overlap on
  wall-clock; every cell's launches go to the one card;
* results are grouped by ``(op, config)`` and diffed across backends via
  ``equivalence.compare_outputs``, producing a structured ``SweepReport``
  with per-cell timing, stall statistics, and localized divergences.

This is the port of ``repro.core.scheduler``: cells keep their outputs as
host numpy arrays, and a failure inside a cell is contained as its
``error`` string, which fails the report.  ``chip_smoke.py``'s ``sweep``
phase sets this scheduler against the sequential per-op loop on the
Fig. 5 batched lane.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bridge import FireBridge
from repro_torch.core.congestion import CongestionConfig, CongestionResult
from repro_torch.core.coverage import CoverageModel
from repro_torch.core.equivalence import EquivalenceReport, compare_outputs
from repro_torch.core.fabric import FabricCluster
from repro_torch.core.fuzz import FaultEvent, FaultPlan


def _freeze(v: Any) -> Tuple:
    """Structural, hashable identity of one config value.

    ``repr`` is NOT identity here: equal numpy arrays are distinct objects
    (and large ones truncate to "..." making *unequal* arrays collide), and
    dataclasses with equal fields repr differently once they hold arrays.
    Hash by structure instead — ndarray by shape/dtype/content digest,
    dataclasses and containers recursively — so equal-valued configs land
    in the same cross-backend equivalence group.
    """
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, str(v.dtype),
                hashlib.sha256(np.ascontiguousarray(v).tobytes())
                .hexdigest())
    if isinstance(v, np.generic):
        # bit-pattern identity, not value identity: item() would make
        # NaN-valued configs unequal to themselves and silently split
        # their equivalence group
        return ("npscalar", str(v.dtype), v.tobytes())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, _freeze(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    if isinstance(v, dict):
        return ("dict", tuple(sorted((str(k), _freeze(x))
                                     for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_freeze(x) for x in v))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(repr(_freeze(x)) for x in v)))
    return (type(v).__name__, repr(v))


def _config_key(config: Dict[str, Any]) -> Tuple:
    """Hashable identity of a cell config (for cross-backend grouping)."""
    return tuple(sorted((k, _freeze(v)) for k, v in config.items()))


@dataclasses.dataclass
class SweepCell:
    """One sweep point: run ``op`` on ``backend`` with ``config`` kwargs.

    Cells sharing ``(op, config)`` across different backends form one
    equivalence group — the paper's golden-model / RTL-sim / deployment
    triangle (Fig. 1) evaluated at one design point.

    ``fault_plan`` is the randomized-stimulus sweep axis (core/fuzz.py):
    when set, the cell's bridge runs fault-injected — each cell forks its
    own deterministic child plan, so concurrent cells reproduce exactly.

    ``devices`` is the scale-out sweep axis: cells with devices > 1 run on
    a ``FabricCluster`` (core/fabric.py) and their gathered host state is
    equivalence-checked against the single-device cells of the same
    ``(op, config)`` group — outputs must match across scales, while the
    modeled link statistics are reported per scale.

    ``topology`` is the interconnect sweep axis riding on ``devices``: a
    core/topology.py builder name (or Topology instance) routes the
    fabric cell through a switched network instead of the crossbar.  It
    stays out of the ``(op, config)`` group key — a 2D-torus 8-device
    run diffs against the same 1-device oracle, because routing may
    reshape *timing*, never gathered results.
    """
    op: str
    backend: str
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    congestion: Optional[CongestionConfig] = None
    fault_plan: Optional[FaultPlan] = None
    devices: int = 1
    topology: Optional[Any] = None
    # open-loop serving lane (serving/arrivals.py): when set, the cell is
    # an open-loop serving run driven by this ArrivalTrace instead of a
    # firmware run — outputs are the generated token streams, which join
    # the same cross-backend/cross-scale equivalence machinery
    serving: Optional[Any] = None

    @property
    def _topo_kind(self) -> Optional[str]:
        if self.topology is None:
            return None
        return (self.topology if isinstance(self.topology, str)
                else self.topology.kind)

    @property
    def label(self) -> str:
        cfg = ",".join(f"{k}={v}" for k, v in sorted(self.config.items()))
        dev = f"x{self.devices}dev" if self.devices > 1 else ""
        topo = f"@{self._topo_kind}" if self.topology is not None else ""
        return f"{self.op}[{cfg}]@{self.backend}{dev}{topo}"

    @property
    def timing_label(self) -> str:
        """Backend-FREE cell identity: the fault-fork label for serving
        cells, so one configuration's fault stream — and therefore its SLO
        rows and log digest — is identical across backends (the
        determinism tier in tests/test_serving_slo.py diffs them)."""
        cfg = ",".join(f"{k}={v}" for k, v in sorted(self.config.items()))
        return f"{self.op}[{cfg}]x{self.devices}dev"

    @property
    def group_member(self) -> str:
        """Key of this cell inside its (op, config) equivalence group."""
        if self.devices == 1 and self.topology is None:
            return self.backend
        member = f"{self.backend}@{self.devices}dev"
        if self.topology is not None:
            member += f"@{self._topo_kind}"
        return member


@dataclasses.dataclass
class CellResult:
    """Outcome of one executed cell."""
    cell: SweepCell
    outputs: Dict[str, np.ndarray]      # final DDR state, buffer name -> arr
    seconds: float                      # wall-clock of the firmware run
    bridge_time: float                  # modeled cycles (congestion-aware)
    congestion: Optional[CongestionResult]
    violations: List[str]
    error: Optional[str] = None
    faults: List[FaultEvent] = dataclasses.field(default_factory=list)
    # per-link Fig. 8 statistics when the cell ran on a FabricCluster
    links: Optional[Dict[str, CongestionResult]] = None
    # data-movement profile (core/profiler.py) when the session ran with
    # profile=True: per-channel stall attribution closing to bridge_time,
    # exportable to Perfetto via SweepReport.save_traces
    profile: Optional[Any] = None
    # the cell's PRIVATE functional-coverage model when the session has a
    # coverage sink: each cell feeds its own model so concurrent cells
    # cannot interleave, and run() merges them in cell order at join —
    # the merged result is identical at any max_workers
    coverage: Optional[CoverageModel] = None
    # latency-SLO report (serving/slo.py) when the cell was an open-loop
    # serving run: p50/p99 TTFT + inter-token latency in modeled cycles,
    # surfaced as extra to_rows columns
    slo: Optional[Any] = None
    # sampled performance-counter identity (core/counters.py): dict with
    # ``digest`` (full stream, comparable among cells sharing
    # ``timing_key``), ``functional`` (scale/backend-invariant digest of
    # functional-scope totals), ``totals`` (name -> cumulative value,
    # summed over banks), and ``timing_key`` — the counter-diff oracle's
    # raw material (None when the cell errored)
    counters: Optional[Dict[str, Any]] = None

    @property
    def link_stall(self) -> float:
        """Total modeled inter-device + host-channel stall cycles."""
        return sum(sum(r.per_engine_stall.values())
                   for r in (self.links or {}).values())

    @property
    def utilization(self) -> Optional[float]:
        """Primary-channel link-bandwidth utilization (None unprofiled)."""
        return (self.profile.utilization()
                if self.profile is not None else None)

    @property
    def attribution(self) -> Optional[Dict[str, float]]:
        """Stall-attribution cycles summed over the cell's channels
        (None unprofiled)."""
        return (self.profile.attribution()
                if self.profile is not None else None)


@dataclasses.dataclass
class SweepReport:
    """Structured sweep outcome (consumed by callers + benchmarks).

    ``equivalence`` holds one localized report per ``(op, config)`` group
    (cross-backend diff of final DDR state, §IV-B); ``passed`` requires
    every group equivalent, no cell errors, no protocol violations.

    ``divergences`` maps each failing group to a minimal
    ``replay.DivergenceReport``: the scheduler re-records the two
    divergent cells as replayable timelines and bisects them, so a failing
    sweep hands back the first divergent transaction + surrounding device
    state instead of just "these backends disagree" (the time-travel debug
    loop, core/replay.py).
    """
    cells: List[CellResult]
    equivalence: Dict[str, EquivalenceReport]
    wall_seconds: float
    divergences: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # merged functional coverage across all cells (deterministic cell-order
    # merge of the per-cell private models) when the session has a sink
    coverage: Optional[CoverageModel] = None
    # counter-diff oracle verdicts (core/counters.py): group label ->
    # {pair, kind, totals} for every group whose sampled counter streams
    # (same timing key) or functional totals (any scale) disagree — the
    # cheap pre-check that fires before the full output diff and
    # escalates into the replay-bisection lane
    counter_mismatches: Dict[str, Any] = dataclasses.field(
        default_factory=dict)

    @property
    def passed(self) -> bool:
        return (all(r.error is None and not r.violations for r in self.cells)
                and all(e.passed for e in self.equivalence.values())
                and not self.counter_mismatches)

    def summary(self) -> dict:
        return {
            "cells": len(self.cells),
            "groups": len(self.equivalence),
            "passed": self.passed,
            "wall_seconds": round(self.wall_seconds, 3),
            "cell_seconds_sum": round(sum(r.seconds for r in self.cells), 3),
            "failures": [g for g, e in self.equivalence.items()
                         if not e.passed] +
                        [r.cell.label for r in self.cells if r.error],
            "divergences": {g: (f"op #{d.op_index} {d.event} ({d.kind}, "
                                f"{d.n_replays} replays)"
                                if hasattr(d, "op_index") else str(d))
                            for g, d in self.divergences.items()},
            "counter_mismatches": {
                g: f"{m['kind']} mismatch: {m['pair'][0]} vs {m['pair'][1]}"
                for g, m in self.counter_mismatches.items()},
        }

    def to_rows(self, wall: bool = True) -> List[str]:
        """CSV-ish rows for benchmark output.  The utilization and
        per-category stall-attribution columns are filled when the session
        ran with ``profile=True`` (core/profiler.py), "-" otherwise.

        ``wall=False`` renders the wall-clock ``seconds`` column as "-",
        leaving only modeled/deterministic quantities — rows are then
        byte-identical at any ``max_workers`` (and across runs), which is
        what the run-farm digests and the ordering-determinism regression
        test compare."""
        from repro_torch.core.profiler import CATEGORIES
        # SLO columns appear only when the sweep contains open-loop serving
        # cells — pure-compute sweeps keep today's schema byte-identically
        with_slo = any(r.slo is not None for r in self.cells)
        header = ("cell,backend,devices,seconds,bridge_cycles,stall_cycles,"
                  "link_stall_cycles,utilization,"
                  + ",".join(f"{c}_cycles" for c in CATEGORIES))
        if with_slo:
            header += ",p50_ttft,p99_ttft,p50_itl,p99_itl,tok_per_kcyc"
        rows = [header + ",status"]
        for r in self.cells:
            stall = (sum(r.congestion.per_engine_stall.values())
                     if r.congestion else 0.0)
            status = "error" if r.error else "ok"
            if r.profile is not None:
                att = r.attribution
                prof_cols = (f"{r.utilization:.4f},"
                             + ",".join(f"{att[c]:.0f}"
                                        for c in CATEGORIES))
            else:
                prof_cols = "-," + ",".join("-" for _ in CATEGORIES)
            if with_slo:
                if r.slo is not None:
                    s = r.slo
                    prof_cols += (f",{s.p50_ttft():.1f},{s.p99_ttft():.1f},"
                                  f"{s.p50_itl():.1f},{s.p99_itl():.1f},"
                                  f"{s.tokens_per_kcycle():.3f}")
                else:
                    prof_cols += ",-,-,-,-,-"
            secs = f"{r.seconds:.3f}" if wall else "-"
            rows.append(f"{r.cell.op},{r.cell.backend},{r.cell.devices},"
                        f"{secs},{r.bridge_time:.0f},{stall:.0f},"
                        f"{r.link_stall:.0f},{prof_cols},{status}")
        return rows

    def save_traces(self, out_dir) -> List[Any]:
        """Write one Perfetto/Chrome-trace JSON per profiled cell under
        ``out_dir`` (requires a ``profile=True`` session); returns the
        written paths.  Load any of them at https://ui.perfetto.dev."""
        from pathlib import Path
        out = Path(out_dir)
        paths = []
        for r in self.cells:
            if r.profile is None:
                continue
            fname = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                            for ch in r.cell.label) + ".trace.json"
            paths.append(r.profile.save_perfetto(out / fname))
        return paths

    def scaling(self) -> List[str]:
        """Cross-scale comparison rows: modeled cycles, link stalls, and
        wall-clock per (op, backend, devices) — the devices-sweep readout
        (the cross-scale readout of a devices sweep)."""
        rows = ["op,backend,devices,bridge_cycles,link_stall_cycles,wall_s"]
        for r in sorted(self.cells, key=lambda r: (r.cell.op, r.cell.backend,
                                                   r.cell.devices)):
            rows.append(f"{r.cell.op},{r.cell.backend},{r.cell.devices},"
                        f"{r.bridge_time:.0f},{r.link_stall:.0f},"
                        f"{r.seconds:.3f}")
        return rows


class CoVerifySession:
    """Batched co-verification sweep scheduler (Fig. 5 batched lane).

    Usage::

        sess = CoVerifySession(firmware)
        sess.register_op("mm", oracle=..., interpret=..., compiled=...)
        sess.add_sweep("mm", backends=("oracle", "interpret"),
                       configs=[{"size": 64}, {"size": 128}])
        report = sess.run(max_workers=4)

    ``firmware(fb, op, backend, **config)`` is the host-side program (data
    movement + CSR protocol + ``fb.launch``); it runs unmodified against
    every backend — the paper's equivalence guarantee.  Backend callables
    are registered once and shared across all cells, so the ``compiled``
    tier compiles once per shape across the sweep; cells execute
    concurrently on a thread pool.
    """

    def __init__(self, firmware: Callable[..., None],
                 congestion: Optional[CongestionConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 fabric_firmware: Optional[Callable[..., None]] = None,
                 link_config: Optional[CongestionConfig] = None,
                 profile: bool = False,
                 coverage: Optional[CoverageModel] = None) -> None:
        self.firmware = firmware
        self.congestion = congestion
        self.fault_plan = fault_plan
        # functional-coverage sink (core/coverage.py).  Cells never write
        # to it concurrently: each cell feeds a PRIVATE model and run()
        # merges them into this sink in cell order after the pool joins,
        # so the merged counts are exact and identical at any max_workers
        # (the thread-pool lost-update fix rode along as a lock inside
        # CoverageModel.hit for externally shared sinks).
        self.coverage = coverage
        # with ``profile`` every cell's bridge/cluster records op marks and
        # CellResult.profile carries the data-movement profile
        # (core/profiler.py): utilization + stall-attribution columns in
        # to_rows, Perfetto export via SweepReport.save_traces
        self.profile = profile
        # scale-out lane (core/fabric.py): when ``fabric_firmware`` is set,
        # or a cell carries devices > 1, the cell runs on a FabricCluster
        # with ``link_config`` fabric links; ``fabric_firmware(fab, op,
        # backend, **config)`` takes the cluster where single-device
        # firmware takes the bridge.  With only ``firmware`` given, it must
        # itself accept the cluster for devices > 1 cells.
        self.fabric_firmware = fabric_firmware
        self.link_config = link_config
        self._ops: Dict[str, Dict[str, Any]] = {}
        self.cells: List[SweepCell] = []
        # open-loop serving lane (register_serving/add_serving_cell)
        self._serving_factory: Optional[Callable[..., Any]] = None

    # ------------------------------------------------------------- setup
    def register_op(self, name: str, *, oracle: Callable,
                    interpret: Optional[Callable] = None,
                    compiled: Optional[Callable] = None,
                    burst_list: Optional[Callable] = None) -> None:
        """Register one accelerator op's backend table, shared by every
        cell in the sweep (the compiled-executable cache)."""
        self._ops[name] = dict(oracle=oracle, interpret=interpret,
                               compiled=compiled, burst_list=burst_list)

    def register_serving(self, factory: Callable[..., Any]) -> None:
        """Register the serving-target builder for open-loop serving
        cells: ``factory(backend, devices, fault_plan)`` returns a
        continuous-batching ``ServingEngine`` (devices == 1) or a
        ``ClusterServingEngine`` — typically sharing one
        prefill/decode pair across all cells, like ``register_op``
        shares backend executables."""
        self._serving_factory = factory

    def add_serving_cell(self, backend: str, trace: Any, *,
                         devices: int = 1,
                         config: Optional[Dict[str, Any]] = None,
                         fault_plan: Optional[FaultPlan] = None
                         ) -> SweepCell:
        """Append one open-loop serving cell: drive ``trace`` (an
        ``ArrivalTrace``) against the registered serving target on
        ``backend`` at ``devices`` scale.  Cells sharing a trace join one
        equivalence group — generated token streams must match across
        backends AND device counts — and each cell's ``CellResult.slo``
        carries the latency-SLO report (extra ``to_rows`` columns)."""
        if self._serving_factory is None:
            raise RuntimeError("no serving factory registered "
                               "(call register_serving first)")
        cfg = dict(config or {})
        cfg.setdefault("trace", trace.label)
        cell = SweepCell("serving", backend, cfg, None,
                         fault_plan or self.fault_plan, devices=devices,
                         serving=trace)
        self.cells.append(cell)
        return cell

    def add_cell(self, op: str, backend: str,
                 config: Optional[Dict[str, Any]] = None,
                 congestion: Optional[CongestionConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 devices: int = 1, topology=None) -> SweepCell:
        """Append one ``(op, backend, config)`` cell to the sweep;
        ``devices > 1`` runs it sharded on a FabricCluster, and
        ``topology`` routes that cluster through a switched interconnect
        (builder name or Topology instance, core/topology.py)."""
        if op not in self._ops:
            raise KeyError(f"op {op!r} not registered")
        cell = SweepCell(op, backend, dict(config or {}),
                         congestion or self.congestion,
                         fault_plan or self.fault_plan,
                         devices=devices, topology=topology)
        self.cells.append(cell)
        return cell

    def add_sweep(self, op: str, backends: Tuple[str, ...],
                  configs: List[Dict[str, Any]],
                  devices: Tuple[int, ...] = (1,),
                  topologies: Tuple[Optional[Any], ...] = (None,)
                  ) -> List[SweepCell]:
        """Cross-product convenience: one cell per (backend, config,
        device count, topology).  Topologies only apply to multi-device
        counts — the 1-device oracle always runs crossbar, once."""
        return [self.add_cell(op, be, cfg, devices=n, topology=t)
                for cfg in configs for be in backends for n in devices
                for t in (topologies if n > 1 else (None,))]

    # ----------------------------------------------------------- execute
    def _run_cell(self, cell: SweepCell) -> CellResult:
        if cell.serving is not None:
            return self._run_serving_cell(cell)
        # each cell forks its own child plan keyed by the cell label, so
        # thread-pool scheduling order cannot perturb the fault stream
        plan = (cell.fault_plan.fork(cell.label)
                if cell.fault_plan is not None else None)
        if cell.devices > 1 or self.fabric_firmware is not None:
            return self._run_fabric_cell(cell, plan)
        cov = CoverageModel() if self.coverage is not None else None
        fb = FireBridge(congestion=cell.congestion, fault_plan=plan,
                        profile=self.profile)
        fb.register_op(cell.op, **self._ops[cell.op])
        t0 = time.perf_counter()
        err: Optional[str] = None
        try:
            self.firmware(fb, cell.op, cell.backend, **cell.config)
        except Exception as e:            # cell failure must not kill sweep
            err = f"{type(e).__name__}: {e}"
        dt = time.perf_counter() - t0
        if cov is not None:
            self._feed_coverage(cov, fb.log, plan)
        return CellResult(
            cell=cell,
            outputs={n: b.array.copy() for n, b in fb.mem.buffers.items()},
            seconds=dt,
            bridge_time=fb.mem.time,
            congestion=fb.congestion_stats(),
            violations=list(fb.log.violations),
            error=err,
            faults=list(plan.events) if plan is not None else [],
            profile=fb.profiler(cell.label) if self.profile else None,
            coverage=cov,
            counters=(self._cell_counters(
                fb, cell, cell.label if plan is not None else None)
                if err is None else None),
        )

    @staticmethod
    def _cell_counters(target: Any, cell: SweepCell,
                       fork_label: Optional[str]) -> Dict[str, Any]:
        """Counter-diff oracle payload of one finished cell
        (core/counters.py).  ``timing_key`` gates the full-stream digest
        comparison: streams are only required to be identical among cells
        with the same device count, topology, congestion seed, and fault
        fork (firmware cells fork their fault stream by the
        backend-DEPENDENT label, so fault-injected firmware streams
        legitimately differ per backend; serving cells fork by the
        backend-free timing label and stay comparable).  The functional
        digest has no such gate — retired tokens/requests/doorbells are
        invariant across backends AND scales."""
        from repro_torch.core import counters as cc
        banks = cc.counter_banks(target)
        return {
            "digest": cc.merged_digest(banks),
            "totals": cc.merged_totals(banks),
            "functional": cc.functional_digest(banks),
            "timing_key": (cell.devices, cell._topo_kind,
                           repr(cell.congestion), fork_label),
        }

    @staticmethod
    def _feed_coverage(cov: CoverageModel, log, plan: Optional[FaultPlan],
                       ) -> None:
        """Feed one finished cell's transaction stream + fault trace into
        its private coverage model (burst/congestion/fault-kind bins)."""
        for tx in log.txs:
            cov.hit_burst(tx.nbytes)
            cov.hit_congestion(tx.stall)
        for ev in (plan.events if plan is not None else []):
            if ev.layer == "bridge":
                cov.hit("fault_kind", ev.kind)

    def _run_serving_cell(self, cell: SweepCell) -> CellResult:
        """One open-loop serving cell: build the target via the registered
        factory, drive the arrival trace through the shared decision loop,
        and collect the SLO report.  The fault plan forks by the
        backend-FREE ``timing_label`` — one configuration has ONE fault
        stream, so SLO rows and log digests are comparable across
        backends (the determinism tier's contract)."""
        from repro_torch.core.replay import target_logs
        from repro_torch.serving.arrivals import run_open_loop
        from repro_torch.serving.slo import SLOReport
        trace = cell.serving
        plan = (cell.fault_plan.fork(cell.timing_label)
                if cell.fault_plan is not None else None)
        cov = CoverageModel() if self.coverage is not None else None
        t0 = time.perf_counter()
        err: Optional[str] = None
        slo = None
        target = self._serving_factory(cell.backend, cell.devices, plan)
        try:
            run_open_loop(target, trace)
            slo = SLOReport.from_run(trace, target, label=cell.label)
        except Exception as e:            # cell failure must not kill sweep
            err = f"{type(e).__name__}: {e}"
        dt = time.perf_counter() - t0
        violations = (list(target.violations)
                      if hasattr(target, "violations")
                      else list(target.mem.log.violations))
        if cov is not None:
            for log in target_logs(target):
                for tx in log.txs:
                    cov.hit_burst(tx.nbytes)
                    cov.hit_congestion(tx.stall)
            self._feed_arrival_coverage(cov, trace, target, violations)
        # the equivalence payload: every completed request's token stream,
        # compared exactly across backends and device counts
        outputs = {f"tokens[{rid}]": np.asarray(req.out_tokens, np.int64)
                   for rid, req in sorted(target.requests.items())
                   if req.done}
        return CellResult(
            cell=cell,
            outputs=outputs,
            seconds=dt,
            bridge_time=float(target.clock),
            congestion=target.congestion_stats(),
            violations=violations,
            error=err,
            faults=list(plan.events) if plan is not None else [],
            profile=target.profiler(cell.label) if self.profile else None,
            coverage=cov,
            slo=slo,
            counters=(self._cell_counters(
                target, cell,
                cell.timing_label if plan is not None else None)
                if err is None else None),
        )

    @staticmethod
    def _feed_arrival_coverage(cov: CoverageModel, trace: Any, target: Any,
                               violations: List[str]) -> None:
        """Arrival/admission coverage bins of one serving cell."""
        cov.hit("arrivals", trace.kind)
        engines = getattr(target, "engines", None) or [target]
        pools = [e.kv_pool for e in engines
                 if getattr(e, "kv_pool", None) is not None]
        deferrals = sum(p.deferrals for p in pools)
        if deferrals:
            cov.hit("arrivals", "deferred", deferrals)
        if any(p.peak_in_use == p.n_pages for p in pools):
            cov.hit("arrivals", "pool_full")
        if any("exceeds KV page pool" in v for v in violations):
            cov.hit("arrivals", "infeasible_reject")

    def _run_fabric_cell(self, cell: SweepCell,
                         plan: Optional[FaultPlan]) -> CellResult:
        """One cell on a FabricCluster: the firmware shards the op across
        ``cell.devices`` devices and the *host-visible gathered state* is
        what enters the cross-scale equivalence group."""
        cov = CoverageModel() if self.coverage is not None else None
        fab = FabricCluster(cell.devices, congestion=cell.congestion,
                            link_config=self.link_config, fault_plan=plan,
                            profile=self.profile, topology=cell.topology,
                            coverage=cov)
        fab.register_op(cell.op, **self._ops[cell.op])
        fw = self.fabric_firmware or self.firmware
        t0 = time.perf_counter()
        err: Optional[str] = None
        try:
            fw(fab, cell.op, cell.backend, **cell.config)
        except Exception as e:            # cell failure must not kill sweep
            err = f"{type(e).__name__}: {e}"
        dt = time.perf_counter() - t0
        if cov is not None:
            for ev in fab.fault_events():
                if ev.layer == "bridge":
                    cov.hit("fault_kind", ev.kind)
        return CellResult(
            cell=cell,
            outputs=fab.outputs(),
            seconds=dt,
            bridge_time=max([fab.time]
                            + [d.mem.time for d in fab.devices]),
            congestion=fab.device_congestion(),
            violations=fab.violations,
            error=err,
            faults=fab.fault_events(),
            links=fab.link_stats(),
            profile=fab.profiler(cell.label) if self.profile else None,
            coverage=cov,
            counters=(self._cell_counters(
                fab, cell, cell.label if plan is not None else None)
                if err is None else None),
        )

    def run(self, max_workers: Optional[int] = None,
            tol: float = 1e-3, bisect_failures: bool = True) -> SweepReport:
        """Execute every cell (concurrently) and cross-check backends.

        Cells are independent, so they are dispatched to a thread pool;
        results are then grouped by ``(op, config)`` and the final DDR
        state is diffed across backends with first-divergence localization
        (equivalence.compare_outputs, §IV-B).

        With ``bisect_failures`` (default), every failing equivalence
        group is re-recorded as a replayable timeline and bisected
        (core/replay.py): the report's ``divergences`` then names the
        first divergent transaction and the device state around it, at
        the cost of re-running only the two divergent cells — the
        debug-iteration path that used to require a manual full re-run.
        """
        t0 = time.perf_counter()
        if max_workers == 1 or len(self.cells) <= 1:
            results = [self._run_cell(c) for c in self.cells]
        else:
            # ex.map preserves submission order, so `results` is in cell
            # order regardless of which thread finishes first — report
            # rows, equivalence groups, divergence attachments, and the
            # coverage merge below are completion-order independent
            with ThreadPoolExecutor(max_workers=max_workers) as ex:
                results = list(ex.map(self._run_cell, self.cells))
        wall = time.perf_counter() - t0
        if self.coverage is not None:
            # deterministic join: merge each cell's private model into the
            # session sink in cell order (never concurrently)
            for r in results:
                if r.coverage is not None:
                    self.coverage.merge(r.coverage)

        groups: Dict[Tuple, Dict[str, Dict[str, np.ndarray]]] = {}
        members: Dict[Tuple, Dict[str, SweepCell]] = {}
        res_groups: Dict[Tuple, Dict[str, CellResult]] = {}
        labels: Dict[Tuple, str] = {}
        for r in results:
            # devices is intentionally NOT part of the key: cells at
            # different scales join one group, so the sweep diffs the
            # 4-device gathered state against the single-device oracle
            key = (r.cell.op, _config_key(r.cell.config))
            groups.setdefault(key, {})[r.cell.group_member] = r.outputs
            members.setdefault(key, {})[r.cell.group_member] = r.cell
            res_groups.setdefault(key, {})[r.cell.group_member] = r
            cfg = ",".join(f"{k}={v}"
                           for k, v in sorted(r.cell.config.items()))
            labels[key] = f"{r.cell.op}[{cfg}]"
        # counter-diff oracle pre-check (core/counters.py): digest
        # comparisons are O(1) against the full element-wise output diff
        # below, so a divergent group is flagged — and handed to the
        # bisection lane — before the expensive comparison even runs
        divergences: Dict[str, Any] = {}
        counter_mismatches: Dict[str, Any] = {}
        for key, rs in res_groups.items():
            mismatch = self._counter_precheck(rs)
            if mismatch is None:
                continue
            counter_mismatches[labels[key]] = mismatch
            if bisect_failures:
                a, b = mismatch["pair"]
                try:
                    divergences[labels[key]] = self._bisect_cells(
                        members[key][a], members[key][b])
                except Exception as e:   # localization is best-effort —
                    divergences[labels[key]] = (   # never fail the sweep
                        f"bisect unavailable: {type(e).__name__}: {e}")
        eq = {labels[k]: compare_outputs(outs, tol=tol)
              for k, outs in groups.items() if len(outs) > 1}
        if bisect_failures:
            for key, outs in groups.items():
                rep = eq.get(labels[key])
                if rep is None or rep.passed or not rep.divergences:
                    continue
                if labels[key] in divergences:
                    continue            # already localized by the oracle
                pair = rep.divergences[0].pair
                cells = members[key]
                try:
                    divergences[labels[key]] = self._bisect_cells(
                        cells[pair[0]], cells[pair[1]])
                except Exception as e:   # localization is best-effort —
                    divergences[labels[key]] = (   # never fail the sweep
                        f"bisect unavailable: {type(e).__name__}: {e}")
        return SweepReport(cells=results, equivalence=eq, wall_seconds=wall,
                           divergences=divergences, coverage=self.coverage,
                           counter_mismatches=counter_mismatches)

    @staticmethod
    def _counter_precheck(rs: Dict[str, "CellResult"]
                          ) -> Optional[Dict[str, Any]]:
        """Counter-diff oracle over one equivalence group: full-stream
        digests must agree among cells sharing a timing key; functional
        digests must agree across ALL members (any backend, any scale).
        Returns a mismatch record ({pair, kind, totals}) or None."""
        with_c = sorted((m, r) for m, r in rs.items()
                        if r.counters is not None)
        if len(with_c) < 2:
            return None
        pair: Optional[Tuple[str, str]] = None
        kind = ""
        by_tk: Dict[Tuple, List[Tuple[str, CellResult]]] = {}
        for m, r in with_c:
            by_tk.setdefault(r.counters["timing_key"], []).append((m, r))
        for peers in by_tk.values():
            ref_m, ref_r = peers[0]
            for m, r in peers[1:]:
                if r.counters["digest"] != ref_r.counters["digest"]:
                    pair, kind = (ref_m, m), "stream"
                    break
            if pair is not None:
                break
        if pair is None:
            ref_m, ref_r = with_c[0]
            for m, r in with_c[1:]:
                if r.counters["functional"] != ref_r.counters["functional"]:
                    pair, kind = (ref_m, m), "functional"
                    break
        if pair is None:
            return None
        return {"pair": pair, "kind": kind,
                "totals": {m: rs[m].counters["totals"] for m in pair}}

    def _bisect_cells(self, cell_a: SweepCell, cell_b: SweepCell,
                      checkpoint_interval: int = 8):
        """Re-record two divergent single-device cells as deterministic
        timelines and bisect them to the first divergent transaction
        (core/replay.py).  The firmware runs unmodified behind a
        ``RecordingBridge`` facade, and each recording rebuilds the cell's
        exact fault-plan fork and congestion link, so the recorded runs
        reproduce the sweep's bit-for-bit."""
        from repro_torch.core import replay as rp
        if cell_a.serving is not None and cell_b.serving is not None:
            # open-loop serving cells replay through the shared decision
            # loop; the recording's factory rebuilds the exact
            # backend-free fault fork the sweep ran with
            def record_serving(cell: SweepCell):
                def factory():
                    plan = (cell.fault_plan.fork(cell.timing_label)
                            if cell.fault_plan is not None else None)
                    return self._serving_factory(cell.backend,
                                                 cell.devices, plan)
                sess = rp.DebugSession(
                    factory, label=cell.label,
                    checkpoint_interval=checkpoint_interval)
                return sess, rp.record_open_loop(sess, cell.serving)

            sa, ra = record_serving(cell_a)
            sb, rb = record_serving(cell_b)
            return rp.bisect_divergence(sa, ra, sb, rb)
        if cell_a.devices != 1 or cell_b.devices != 1 \
                or self.fabric_firmware is not None:
            raise ValueError("divergence bisection covers single-device "
                             "cells (fabric timelines differ per scale)")

        def record(cell: SweepCell):
            def factory():
                plan = (cell.fault_plan.fork(cell.label)
                        if cell.fault_plan is not None else None)
                fb = FireBridge(congestion=cell.congestion, fault_plan=plan)
                fb.register_op(cell.op, **self._ops[cell.op])
                return fb
            sess = rp.DebugSession(factory, label=cell.label,
                                   checkpoint_interval=checkpoint_interval)
            rec = sess.record(lambda r: self.firmware(
                rp.RecordingBridge(r), cell.op, cell.backend,
                **cell.config))
            return sess, rec

        sa, ra = record(cell_a)
        sb, rb = record(cell_b)
        return rp.bisect_divergence(sa, ra, sb, rb)


def run_sequential(session: CoVerifySession, tol: float = 1e-3
                   ) -> SweepReport:
    """The pre-batching baseline: execute the same cells one at a time on
    fresh per-cell state (no thread pool).  Kept as the comparison lane for
    the Fig. 5 sweep measurement."""
    return session.run(max_workers=1, tol=tol)
