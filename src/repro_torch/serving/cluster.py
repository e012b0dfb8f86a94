"""Cluster-aware serving: N device-local ServingEngines behind ONE CSR
control plane, with prompt and token DMA contending on a modeled
host↔fabric channel (paper §IV-A at FireSim scale; core/fabric.py is the
same interconnect model under the co-verification sweeps) — the port of
``repro.serving.cluster``.

Firmware talks to the cluster exactly as it talks to a single engine —
write the prompt into ``prompt_in``, program SUBMIT_*, ring DOORBELL,
poll COMPLETED — and the front control plane round-robins request slots
across the device-local engines.  Every prompt upload crosses the shared
host channel before it reaches the target device, and every retired
request's token row crosses it back, so cluster serving traffic contends
on the fabric the way the paper's DMA VIPs contend on the AXI
interconnect (Fig. 8 statistics from ``fabric_stats()``).

The prefill / decode callables are shared: the first engine builds them
once and its ``jit_fns`` seed the other devices, which also share the
parameters.  The "devices" are modeled: every engine's cache and the
parameters live on the one ``device`` (default ``"cuda"``).  The control
plane is the reference's, line for line, so the transaction logs, and with
them the committed cluster golden traces, are the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bridge import MemoryBridge
from repro_torch.core.congestion import (CongestionConfig, CongestionResult,
                                         LinkModel)
from repro_torch.core.counters import (CounterBank, CounterSpec,
                                       register_link_counters,
                                       register_switch_port_counters)
from repro_torch.core.fabric import FABRIC_LINK
from repro_torch.core.registers import RO, RegisterFile
from repro_torch.core.switch import SwitchFabric
from repro_torch.core.topology import build_topology
from repro_torch.core.transactions import BurstBatch, TransactionLog
# the front-end mirrors the single engine's CSR map exactly (firmware
# drives either interchangeably); only NDEV is cluster-specific
from repro_torch.serving.engine import (ACTIVE, COMPLETED, CTRL, DOORBELL,
                                        STATUS, SUBMIT_ID, SUBMIT_LEN,
                                        SUBMIT_MAXNEW, Request, ServingEngine)

NDEV = 0x20


class ClusterServingEngine:
    """One CSR front-end, N device-local engines, one contended fabric."""

    def __init__(self, cfg, params, *, n_devices: int = 2,
                 max_slots: int = 2, max_len: int = 256,
                 flags=None, prompt_pad: int = 16,
                 congestion: Optional[CongestionConfig] = None,
                 link_config: Optional[CongestionConfig] = None,
                 fault_plan=None, topology=None,
                 batching: str = "storm",
                 kv_pages: Optional[int] = None,
                 kv_page_size: int = 16,
                 kv_leak_every: int = 0,
                 step_cycles: float = 64.0,
                 device: Union[str, torch.device] = "cuda"):
        if n_devices < 1:
            raise ValueError(f"need at least one device, got {n_devices}")
        self.n = n_devices
        self.max_slots = max_slots          # per device
        self.max_len = max_len
        # scheduling mode + per-device KV paging forwarded to every
        # device-local engine (see ServingEngine; each device owns its own
        # page pool — admission control is local to the routed engine)
        if batching not in ("storm", "continuous"):
            raise ValueError(f"unknown batching mode {batching!r}")
        self.batching = batching
        self._serve_kw = dict(batching=batching, kv_pages=kv_pages,
                              kv_page_size=kv_page_size,
                              kv_leak_every=kv_leak_every,
                              step_cycles=step_cycles)
        self.link_config = link_config if link_config is not None \
            else FABRIC_LINK
        self._fault_plan = fault_plan
        # optional switched interconnect (core/topology.py): prompt
        # uploads and token writebacks then additionally cross the switch
        # hops between the host attachment and the engine's switch, so
        # writeback contention becomes placement-dependent
        if isinstance(topology, str):
            topology = build_topology(topology, n_devices)
        if topology is not None and topology.n_devices != n_devices:
            raise ValueError(
                f"topology {topology.kind!r} describes "
                f"{topology.n_devices} devices, cluster has {n_devices}")
        self._topology = topology

        def _child_plan(plan, i):
            return plan.fork(f"cluster/e{i}") if plan is not None else None

        def _kw(i):
            # per-device DDR links get distinct DoS seeds (engine 0 keeps
            # the caller's seed), matching FabricCluster's decorrelation
            kw = dict(max_slots=max_slots, max_len=max_len,
                      prompt_pad=prompt_pad, device=device,
                      congestion=(dataclasses.replace(
                          congestion, seed=congestion.seed + i)
                          if congestion is not None else None),
                      **self._serve_kw)
            if flags is not None:
                kw["flags"] = flags
            return kw

        first = ServingEngine(cfg, params,
                              fault_plan=_child_plan(fault_plan, 0),
                              **_kw(0))
        self.engines: List[ServingEngine] = [first] + [
            ServingEngine(cfg, params, jit_fns=first.jit_fns,
                          fault_plan=_child_plan(fault_plan, i), **_kw(i))
            for i in range(1, n_devices)]
        self._init_control_plane(fault_plan)

    def _init_control_plane(self, fault_plan) -> None:
        self.log = TransactionLog()
        self.host_link = LinkModel(self.link_config)
        # host-channel traffic is fault-plan-aware like every other fabric
        # link (a forked child, so the cluster reproduces from one seed)
        self.link_plan = (fault_plan.fork("cluster/links")
                          if fault_plan is not None else None)
        # fresh switch state per control-plane (re)init, so reset() also
        # resets flit arbitration and credit windows
        self.switch = (SwitchFabric(self._topology, self.link_config)
                       if self._topology is not None else None)
        self.time = 0.0
        self.mem = MemoryBridge(self.log)       # host staging DDR
        self.mem.alloc("prompt_in", (self.max_len,), np.int32)
        self.rows = self.n * self.max_slots
        self.mem.alloc("tokens_out", (self.rows, self.max_len), np.int32)
        self.csr = RegisterFile("cluster.csr", self.log)
        self.csr.define("CTRL", CTRL)
        self.csr.define("STATUS", STATUS, access=RO)
        self.csr.define("DOORBELL", DOORBELL, on_write=self._on_doorbell)
        self.csr.define("SUBMIT_ID", SUBMIT_ID)
        self.csr.define("SUBMIT_LEN", SUBMIT_LEN)
        self.csr.define("SUBMIT_MAXNEW", SUBMIT_MAXNEW)
        self.csr.define("COMPLETED", COMPLETED, access=RO)
        self.csr.define("ACTIVE", ACTIVE, access=RO)
        self.csr.define("NDEV", NDEV, access=RO, reset=self.n)
        self._rr = 0                            # round-robin pointer
        self.completed = 0
        self._written: Set[Tuple[int, int]] = set()   # (engine, rid) done
        self.placement: Dict[int, int] = {}     # rid -> engine index
        # front-side counter banks (core/counters.py): the shared host
        # channel plus one bank per switch port when a topology is routed
        hb = CounterBank("cluster/host")
        register_link_counters(hb, self.host_link)
        hb.register(CounterSpec("transactions", "events"),
                    probe=lambda: self.log.n_txs)
        self._counter_banks: List[CounterBank] = [hb]
        if self.switch is not None:
            for sp in self.switch.ports:
                sb = CounterBank(f"cluster/sw:{sp.label}")
                register_switch_port_counters(sb, sp)
                self._counter_banks.append(sb)

    def reset(self, fault_plan=None) -> None:
        """Fresh cluster state at warm-jit cost (mirrors
        ServingEngine.reset, including its semantics: ``fault_plan=None``
        CLEARS any installed plan; pass a plan to fault-inject the rerun).
        Used by fuzz/storm reruns."""
        self._fault_plan = fault_plan
        for i, eng in enumerate(self.engines):
            eng.reset(fault_plan=(fault_plan.fork(f"cluster/e{i}")
                                  if fault_plan is not None else None))
        self._init_control_plane(fault_plan)

    # ----------------------------------------------------------- fabric DMA
    def _dma(self, engine: str, kind: str, addr: int, nbytes: int,
             tag: str, at: Optional[float] = None,
             dev: Optional[int] = None) -> float:
        """One transfer over the shared host↔fabric channel, burst-split
        (BurstBatch.from_transfer — same splitter as the fabric links),
        fault-perturbed, and congestion-arbitrated (this is where cluster
        prompt uploads and token writebacks contend).  ``at`` sets the
        min-issue time — transfers sharing one scheduler tick issue
        together and therefore contend, instead of serializing in program
        order.

        With a topology installed and ``dev`` given, the transfer is a
        store-and-forward journey: outbound (``h->e*``) crosses the host
        channel then the flit-framed, credit-flow-controlled switch hops
        toward the engine's switch; inbound (``e*->h``) crosses the
        switch hops first.  ``dev=None`` (or no topology) keeps the
        single-channel crossbar path bit-exactly."""
        t = self.time if at is None else at
        hops = [(self.host_link, self.link_config.max_burst_bytes, None)]
        if self.switch is not None and dev is not None:
            outbound = engine.startswith("h->")
            ports = (self.switch.route_ports("h", dev) if outbound
                     else self.switch.route_ports(dev, "h"))
            sw = [(p.link, self._topology.flit_bytes, p) for p in ports]
            hops = hops + sw if outbound else sw + hops
        for link, step, port in hops:
            if port is not None:
                t = port.acquire(t)
            batch = BurstBatch.from_transfer(t, engine, kind, addr,
                                             nbytes, tag, step)
            if self.link_plan is not None:
                batch = self.link_plan.perturb_batch(batch, self.log)
            t = link.submit_batch(batch, self.log)
            if port is not None:
                port.release(batch.rec["complete"].tolist())
        self.time = max(self.time, t)
        self._tick_counters(self.time)
        return t

    def _tick_counters(self, now: float) -> None:
        for b in self._counter_banks:
            b.tick(now)

    # ------------------------------------------------------ front protocol
    def _on_doorbell(self, _data: int) -> None:
        rid = self.csr.hw_get("SUBMIT_ID")
        ln = self.csr.hw_get("SUBMIT_LEN")
        mx = self.csr.hw_get("SUBMIT_MAXNEW")
        # cluster-wide in-flight duplicate check: the per-engine check
        # cannot see a duplicate that round-robin routed to a DIFFERENT
        # engine, so the front-end must enforce the same no-silent-
        # overwrite guarantee the single engine gives
        holder = next((e for e in self.engines if rid in e.requests), None)
        if holder is not None and not holder.requests[rid].done:
            self.csr.log.violation(
                f"duplicate SUBMIT_ID {rid}: request still in flight")
            return
        i = self._rr % self.n
        eng = self.engines[i]
        # prompt DMA: host staging buffer -> device-local prompt_in over
        # the shared channel (a bad request still paid for its upload).
        # In continuous mode the upload issues at the cluster clock and
        # the routed engine's clock absorbs its completion, so queueing
        # behind a congested host channel is visible in TTFT.
        src = self.mem.buffers["prompt_in"]
        at = max(self.time, self.clock) if self.batching == "continuous" \
            else None
        t_up = self._dma(f"h->e{i}", "write", src.addr, src.nbytes,
                         "prompt_in", at=at, dev=i)
        if self.batching == "continuous":
            eng.advance_clock(t_up)
        np.copyto(eng.mem.buffers["prompt_in"].array, src.array)
        # forward the submission through the device-local CSR protocol;
        # remaining validation (bad length, KV budget) happens there and
        # violations land in the device log — see `violations`
        before = eng.requests.get(rid)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_ID"), rid)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_LEN"), ln)
        eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_MAXNEW"), mx)
        eng.csr.fb_write_32(eng.csr.addr_of("DOORBELL"), 1)
        after = eng.requests.get(rid)
        if after is not None and after is not before:   # accepted
            # the round-robin pointer advances only on acceptance, so a
            # storm of rejected submissions cannot skew live slots onto
            # one engine
            self._rr += 1
            self.placement[rid] = i
            # recycling a retired id must re-arm its writeback (a stale
            # _written marker would suppress the new request's token DMA
            # and COMPLETED update forever)
            self._written.discard((i, rid))
            # ...and drop a retired request left on another engine, so
            # the merged `requests` view stays unambiguous (ids recycle
            # only after retirement, as in the single engine)
            for j, other in enumerate(self.engines):
                if other is not eng and rid in other.requests:
                    del other.requests[rid]
                    self._written.discard((j, rid))

    # ------------------------------------------------------------ schedule
    def step(self) -> int:
        """One cluster tick: every engine steps once; newly retired
        requests stream their token rows back over the shared channel,
        all issuing at the tick boundary so concurrent retirements from
        different devices contend for channel bandwidth."""
        tick = self.time
        for i, eng in enumerate(self.engines):
            eng.step()
            # continuous mode: the retired row leaves when the engine
            # retired it (its modeled clock), not at the cluster tick base
            self._writeback(i, eng,
                            eng.clock if self.batching == "continuous"
                            else tick)
        active = self._n_active()
        self.csr.hw_set("ACTIVE", active)
        self._tick_counters(self.clock)
        return active

    def _writeback(self, i: int, eng: ServingEngine, tick: float) -> None:
        out = self.mem.buffers["tokens_out"]
        row_bytes = out.array[0].nbytes
        for rid in sorted(r for r, req in eng.requests.items()
                          if req.done and (i, r) not in self._written):
            self._written.add((i, rid))
            row = self.completed % self.rows
            toks = eng.requests[rid].out_tokens
            out.array[row, :] = 0
            out.array[row, :len(toks)] = toks
            self._dma(f"e{i}->h", "write", out.addr + row * row_bytes,
                      row_bytes, f"tokens[{rid}]", at=tick, dev=i)
            self.completed += 1
            self.csr.hw_set("COMPLETED", self.completed & 0xFFFFFFFF)

    def _n_active(self) -> int:
        return sum(e._n_active() for e in self.engines)

    def _n_pending(self) -> int:
        return sum(len(e.pending) for e in self.engines)

    # ------------------------------------------------------- modeled clock
    @property
    def clock(self) -> float:
        """Cluster-level modeled clock: the front of all time domains
        (host channel + every device-local engine clock).  The open-loop
        driver (serving/arrivals.py) reads this to decide which arrivals
        are due."""
        return max([self.time] + [e.clock for e in self.engines])

    def advance_clock(self, t: float) -> None:
        """Fast-forward every device-local clock to ``t`` (idle-gap skip
        by the open-loop driver; never moves time backwards)."""
        for e in self.engines:
            e.advance_clock(t)

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        self.csr.hw_set("STATUS", 1)
        for _ in range(max_ticks):
            if not self._n_pending() and not self._n_active():
                break
            self.step()
        self.csr.hw_set("STATUS", 2)

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> dict:
        """Whole-cluster snapshot at a tick boundary (core/replay.py):
        every device-local engine, the front control plane (staging DDR +
        CSR + front log, which ``mem`` carries), the shared host channel,
        the channel fault plan, and the placement bookkeeping."""
        return {
            "engines": [e.get_state() for e in self.engines],
            "mem": self.mem.get_state(),    # front staging DDR + self.log
            "csr": self.csr.get_state(),
            "host_link": self.host_link.get_state(),
            "switch": (self.switch.get_state()
                       if self.switch is not None else None),
            "link_plan": (self.link_plan.get_state()
                          if self.link_plan is not None else None),
            "time": self.time,
            "rr": self._rr,
            "completed": self.completed,
            "written": set(self._written),
            "placement": dict(self.placement),
            "counters": [b.get_state() for b in self._counter_banks],
        }

    def set_state(self, state: dict) -> None:
        for e, s in zip(self.engines, state["engines"]):
            e.set_state(s)
        self.mem.set_state(state["mem"])
        self.csr.set_state(state["csr"])
        self.host_link.set_state(state["host_link"])
        if self.switch is not None and state.get("switch") is not None:
            self.switch.set_state(state["switch"])
        if state["link_plan"] is not None:
            self.link_plan.set_state(state["link_plan"])
        self.time = state["time"]
        self._rr = state["rr"]
        self.completed = state["completed"]
        self._written = set(state["written"])
        self.placement = dict(state["placement"])
        for b, s in zip(self._counter_banks, state.get("counters") or []):
            b.set_state(s)

    # ---------------------------------------------------------- inspection
    @property
    def requests(self) -> Dict[int, Request]:
        """Merged rid -> Request view across the device-local engines."""
        out: Dict[int, Request] = {}
        for eng in self.engines:
            out.update(eng.requests)
        return out

    @property
    def violations(self) -> List[str]:
        out = list(self.csr.log.violations)
        for i, eng in enumerate(self.engines):
            out += [f"[e{i}] {v}" for v in eng.csr.log.violations]
        return out

    def fabric_stats(self) -> CongestionResult:
        """Fig. 8 stall statistics of the shared host↔fabric channel
        (prompt uploads + token writebacks, all engines contending)."""
        return self.host_link.result()

    def profiler(self, label: str = "cluster"):
        """Data-movement profile of the cluster (core/profiler.py): the
        shared host channel (where ``h->e*`` prompt uploads contend with
        ``e*->h`` token writebacks — ``serving_rows`` splits them) plus
        every device-local engine's DDR/CSR channels."""
        from repro_torch.core.profiler import DataMovementProfiler
        return DataMovementProfiler(self, label=label)

    def congestion_stats(self) -> CongestionResult:
        return self.fabric_stats()

    def counter_banks(self) -> List[CounterBank]:
        """All cluster counter banks: front (host channel + switch ports)
        followed by every device-local engine's banks, engine order."""
        out = list(self._counter_banks)
        for eng in self.engines:
            out.extend(eng.counter_banks())
        return out

    def digest(self) -> str:
        """Reproducibility witness over the front log and device logs."""
        import hashlib
        h = hashlib.sha256()
        h.update(self.log.digest().encode())
        for eng in self.engines:
            h.update(eng.mem.log.digest().encode())
        return h.hexdigest()
