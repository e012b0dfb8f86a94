"""Multi-device co-verification fabric (paper §IV-C scaled out).

The paper's end state is verifying firmware that orchestrates *several*
subsystems over a shared memory fabric; FireSim showed the same move for
cycle-accurate simulation — many simulated nodes joined by a *modeled*
network.  ``FabricCluster`` is that shape here: N independent
``FireBridge`` devices (each with its own DDR, CSR space, transaction log,
and optionally its own online congestion link and forked fault plan)
joined by a modeled interconnect built from ``core/congestion.py``
pieces:

* one ``LinkModel`` per device **port** (the device's bidirectional fabric
  attachment — transfers from and to the device contend on it, the way tx
  and rx DMA contend on a NIC), and
* one shared **host↔fabric DMA channel** that every scatter/gather and
  cluster-serving token writeback must cross.

With ``topology=None`` (the default) the ports hang off one implicit
zero-hop crossbar: a transfer is a read leg on the source attachment and
a write leg on the destination attachment, both issued at the fabric
clock.  With a ``Topology`` (core/topology.py — ring / 2D-torus /
fat-tree) installed, every transfer instead travels a **multi-hop
journey** through the modeled switch graph (core/switch.py): the source
leg, then one flit-framed, credit-flow-controlled switch hop per link on
the static route (store-and-forward — each hop issues at the previous
hop's completion), then the destination leg.  Inter-device stalls become
placement-dependent, the profiler attributes contention per hop, and
``all_reduce`` switches to a hierarchical tree that exploits switch
locality.  The crossbar path is byte-for-byte unchanged — the
pre-topology golden traces pin it.

Every fabric transfer — ``dev_copy``, ``scatter``/``broadcast``/
``gather`` of sharded buffers, and the ``all_reduce`` collective —
is split into link-level bursts, arbitrated through the port models
(advancing the fabric clock and accumulating per-link stall statistics),
logged in the fabric ``TransactionLog``, and routed through a forked
fault plan when one is installed.  Same seed ⇒ identical fabric + device
transaction streams, witnessed by ``digest()``.

``sharded_launch`` runs one accelerator op sharded across the cluster
using the ``sharding/specs.py`` fabric layouts (scatter the sharded
inputs, broadcast the replicated ones, device-local launches, gather the
output) — the gathered result is bit-identical to the single-device run
because the layouts never split a reduction axis.

The cluster itself is host numpy (DDR buffers, links, clocks); the
accelerator ops run wherever the registered backend table puts them — on
``"cuda"`` by default, every modeled device's launches on the one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bridge import FireBridge, MemoryBridge
from repro_torch.core.congestion import (CongestionConfig, CongestionResult,
                                         LinkModel)
from repro_torch.core.counters import (CounterBank, CounterSpec,
                                       register_link_counters,
                                       register_switch_port_counters)
from repro_torch.core.switch import SwitchFabric
from repro_torch.core.topology import Topology, build_topology
from repro_torch.core.transactions import (BurstBatch, OpMark,
                                           TransactionLog, record_mark)
from repro_torch.sharding.specs import fabric_shard_axis

# Default fabric-link parameters: an inter-device serdes link is narrower
# and longer-latency than the device-local DDR interface modeled by the
# bridge's own CongestionConfig defaults.
FABRIC_LINK = CongestionConfig(link_bytes_per_cycle=64.0, base_latency=100.0,
                               max_burst_bytes=4096)


def shard_runs(shape: Tuple[int, ...], itemsize: int, axis: int,
               lo: int, hi: int) -> List[Tuple[int, int]]:
    """Byte-level (offset, length) runs a shard ``[lo, hi)`` along ``axis``
    occupies inside the C-ordered host buffer.

    For axis 0 a shard is one contiguous run; for inner axes the shard's
    rows interleave through the buffer, so the host-side DMA legs must be
    logged as ``prod(shape[:axis])`` strided runs — otherwise the
    transaction stream attributes traffic to addresses the data never
    touches (Fig. 9 heatmaps, golden traces)."""
    outer = int(np.prod(shape[:axis], dtype=np.int64)) if axis else 1
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64)) * itemsize
    stride = shape[axis] * inner
    run_len = (hi - lo) * inner
    if run_len == 0:
        return []
    return [(o * stride + lo * inner, run_len) for o in range(outer)]


class FabricCluster:
    """N FireBridge devices behind a modeled interconnect (§IV-C at scale).

    ``congestion`` configures each device's *local* memory link (as for a
    single ``FireBridge``); ``link_config`` configures the fabric ports and
    the host↔fabric channel (defaults to ``FABRIC_LINK``).  ``fault_plan``
    is forked once per device and once for the fabric links, so the whole
    cluster reproduces from one seed regardless of device count.
    ``coverage`` (core/coverage.py) observes fabric operations, burst
    sizes, and link congestion states when provided.

    ``topology`` routes inter-device and host traffic through a modeled
    switch graph instead of the implicit crossbar: a ``Topology``
    instance (core/topology.py), or a builder name (``"ring"``,
    ``"torus2d"``, ``"fat_tree"``) applied to ``n_devices``.  ``None``
    keeps crossbar timing bit-exactly (golden traces).
    """

    def __init__(self, n_devices: int, *, name: str = "fab",
                 congestion: Optional[CongestionConfig] = None,
                 link_config: Optional[CongestionConfig] = None,
                 fault_plan=None, coverage=None,
                 profile: bool = False, topology=None) -> None:
        if n_devices < 1:
            raise ValueError(f"need at least one device, got {n_devices}")
        self.n = n_devices
        self.name = name
        self.log = TransactionLog()            # fabric interconnect log
        self.coverage = coverage
        # data-movement profiling (core/profiler.py): fabric transfers and
        # collective legs are op-marked so the profiler can attribute
        # bytes/stalls per collective step (all_reduce leg attribution)
        self.profile = profile
        self.marks: List[OpMark] = []
        self.link_config = link_config if link_config is not None \
            else FABRIC_LINK
        self.fault_plan = (fault_plan.fork(f"{name}/links")
                           if fault_plan is not None else None)
        # device-local DDR links get distinct DoS seeds (device 0 keeps
        # the caller's seed, so it times identically to a standalone
        # bridge); without the reseed every device would stall at the
        # same points — artificially synchronized cross-device timing
        self.devices = [
            FireBridge(f"{name}{i}",
                       congestion=(dataclasses.replace(
                           congestion, seed=congestion.seed + i)
                           if congestion is not None else None),
                       fault_plan=(fault_plan.fork(f"{name}/dev{i}")
                                   if fault_plan is not None else None),
                       profile=profile)
            for i in range(n_devices)]
        lc = self.link_config
        # distinct DoS streams per link, all derived from one seed
        self.host_link = LinkModel(lc)
        self.ports = [LinkModel(dataclasses.replace(lc, seed=lc.seed + 1 + i))
                      for i in range(n_devices)]
        # routed interconnect (core/switch.py): None = implicit crossbar
        if isinstance(topology, str):
            topology = build_topology(topology, n_devices)
        if topology is not None and topology.n_devices != n_devices:
            raise ValueError(
                f"topology {topology.kind!r} describes "
                f"{topology.n_devices} devices, cluster has {n_devices}")
        self.topology: Optional[Topology] = topology
        self.switch = (SwitchFabric(topology, lc)
                       if topology is not None else None)
        if coverage is not None:
            coverage.hit("topology",
                         topology.kind if topology is not None
                         else "crossbar")
        # host-side staging DDR (firmware-visible; host accesses are free,
        # crossing the fabric is not)
        self.host = MemoryBridge(self.log)
        self.time = 0.0
        # always-on sampled counters (core/counters.py): one bank per
        # fabric channel — the shared host link, every device port, and
        # (routed) every switch port with its credit flow-control
        # counters.  Probes only read arbiter state; ticks happen after
        # an issue completes, so timing/logs are unaffected.
        self._counter_banks: List[CounterBank] = []
        hb = CounterBank("fabric/host")
        register_link_counters(hb, self.host_link)
        hb.register(CounterSpec("transactions", "events"),
                    lambda: self.log.n_txs)
        hb.register(CounterSpec("faults", "events"),
                    lambda: len(self.log.faults))
        self._counter_banks.append(hb)
        for i, port in enumerate(self.ports):
            pb = CounterBank(f"fabric/port{i}")
            register_link_counters(pb, port)
            self._counter_banks.append(pb)
        if self.switch is not None:
            for sp in self.switch.ports:
                sb = CounterBank(f"fabric/sw:{sp.label}")
                register_switch_port_counters(sb, sp)
                self._counter_banks.append(sb)

    # ------------------------------------------------------------- devices
    def register_op(self, op: str, **table) -> None:
        """Register one op's backend table on every device."""
        for d in self.devices:
            d.register_op(op, **table)

    def launch(self, dev: int, op: str, backend: str, in_bufs: List[str],
               out_bufs: List[str], **kw) -> None:
        """Device-local accelerator launch (see FireBridge.launch)."""
        self.devices[dev].launch(op, backend, in_bufs, out_bufs, **kw)

    def _dev_alloc(self, dev: int, name: str, shape, dtype):
        """Allocate (or reuse, on exact shape/dtype match) a device buffer."""
        mem = self.devices[dev].mem
        buf = mem.buffers.get(name)
        if buf is not None:
            if buf.array.shape != tuple(shape) or buf.array.dtype != dtype:
                raise ValueError(
                    f"device {dev} buffer {name!r} exists with shape "
                    f"{buf.array.shape}/{buf.array.dtype}, need "
                    f"{tuple(shape)}/{np.dtype(dtype)}")
            return buf
        return mem.alloc(name, shape, dtype)

    def alloc_sharded(self, name: str, shape, dtype,
                      axis: Optional[int] = 0) -> None:
        """Allocate ``name`` on every device: split along ``axis``
        (np.array_split bounds), or full-shape replicas when axis is None."""
        if axis is None:
            for i in range(self.n):
                self._dev_alloc(i, name, shape, dtype)
            return
        for i, (lo, hi) in enumerate(self._shard_bounds(shape[axis])):
            sh = tuple(shape[:axis]) + (hi - lo,) + tuple(shape[axis + 1:])
            self._dev_alloc(i, name, sh, dtype)

    # --------------------------------------------------------------- links
    def _leg(self, link: LinkModel, engine: str, kind: str, addr: int,
             nbytes: int, tag: str,
             runs: Optional[List[Tuple[int, int]]] = None
             ) -> Optional[Tuple[LinkModel, BurstBatch]]:
        """Build one fabric transfer leg as a burst batch — no submission
        yet.  A launch's legs are all built against the same fabric clock
        (``self.time`` only advances after the issuing op's leg loop) and
        then issued together by ``_issue_legs``.  ``runs`` overrides the
        single contiguous (addr, nbytes) range with a list of strided
        byte runs (inner-axis shards of a host buffer).  Returns None for
        an empty leg (nothing moves, no burst, no fault draw — matches
        all_reduce's degenerate skip)."""
        rl = [(a, nb) for a, nb in (runs if runs is not None
                                    else [(addr, nbytes)]) if nb > 0]
        if not rl:
            return None
        return (link, BurstBatch.from_runs(
            self.time, engine, kind, rl, tag,
            self.link_config.max_burst_bytes))

    def _issue_legs(self, legs: List[Optional[Tuple[LinkModel, BurstBatch]]]
                    ) -> float:
        """Issue one launch's legs in build order: each leg's batch is
        fault-perturbed, arbitrated on its own link, and logged.  Per-link
        submission order and batch boundaries are identical to per-leg
        issuing, so arbitration streams (and golden traces) are unchanged
        — only the Python orchestration is batched."""
        done = self.time
        for leg in legs:
            if leg is None:
                continue
            link, batch = leg
            if self.fault_plan is not None:
                batch = self.fault_plan.perturb_batch(batch, self.log)
            d = link.submit_batch(batch, self.log)
            if d > done:
                done = d
            if self.coverage is not None:
                for nb, st in zip(batch.rec["nbytes"].tolist(),
                                  batch.rec["stall"].tolist()):
                    self.coverage.hit_burst(nb)
                    self.coverage.hit_congestion(st)
        self._tick_counters(done)
        return done

    # ------------------------------------------------------ routed journeys
    def _journey(self, src, dst, engine: str, src_runs, dst_runs,
                 src_tag: str, dst_tag: str):
        """Hop list for one routed transfer unit between endpoints (device
        index or ``'h'`` for the host staging DDR): the source-attachment
        read leg, one flit-framed switch hop per link on the static route
        (carrying the destination byte runs), and the destination-
        attachment write leg.  Hop = (link, engine, kind, runs, tag,
        burst step, SwitchPort-or-None).  Returns None when nothing moves
        (mirrors ``_leg``'s empty-leg skip)."""
        src_runs = [(a, nb) for a, nb in src_runs if nb > 0]
        dst_runs = [(a, nb) for a, nb in dst_runs if nb > 0]
        if not src_runs or not dst_runs:
            return None
        mb = self.link_config.max_burst_bytes
        src_link = self.host_link if src == "h" else self.ports[src]
        dst_link = self.host_link if dst == "h" else self.ports[dst]
        hops = [(src_link, engine, "read", src_runs, src_tag, mb, None)]
        for p in self.switch.route_ports(src, dst):
            hops.append((p.link, engine, "flit", dst_runs, dst_tag,
                         self.topology.flit_bytes, p))
        hops.append((dst_link, engine, "write", dst_runs, dst_tag, mb,
                     None))
        return hops

    def _issue_journeys(self, journeys) -> float:
        """Issue routed journeys wave by wave: wave k carries every
        journey's k-th hop, each hop's batch issuing at that journey's
        previous-hop completion (store-and-forward).  Journeys therefore
        pipeline — journey B's source leg contends with journey A's
        source leg, not with A's deepest hop — and shared switch ports
        arbitrate the flit trains of every journey crossing them.  Switch
        hops additionally pay credit-based flow control before entering
        the port (core/switch.py)."""
        cov = self.coverage
        js = [j for j in journeys if j is not None]
        if cov is not None:
            for j in js:
                cov.hit_hops(len(j) - 2)
        done = self.time
        ready = [self.time] * len(js)
        for k in range(max((len(j) for j in js), default=0)):
            for ji, j in enumerate(js):
                if k >= len(j):
                    continue
                link, engine, kind, runs, tag, step, port = j[k]
                t = ready[ji]
                if port is not None:
                    t_in = port.acquire(t)
                    if cov is not None:
                        cov.hit("credit_stall",
                                "waited" if t_in > t else "granted")
                    t = t_in
                batch = BurstBatch.from_runs(t, engine, kind, runs, tag,
                                             step)
                if self.fault_plan is not None:
                    batch = self.fault_plan.perturb_batch(batch, self.log)
                d = link.submit_batch(batch, self.log)
                if port is not None:
                    port.release(batch.rec["complete"].tolist())
                ready[ji] = d
                if d > done:
                    done = d
                if cov is not None:
                    for nb, st in zip(batch.rec["nbytes"].tolist(),
                                      batch.rec["stall"].tolist()):
                        cov.hit_burst(nb)
                        cov.hit_congestion(st)
        self._tick_counters(done)
        return done

    def _cover(self, op: str) -> None:
        if self.coverage is not None:
            self.coverage.hit("fabric", op)

    def _tick_counters(self, now: float) -> None:
        """Sample every fabric bank up to ``now`` — called after each
        issue wave, i.e. at the points the fabric clock advances."""
        for b in self._counter_banks:
            b.tick(now)

    def counter_banks(self) -> List[CounterBank]:
        """All cluster banks in stable order (fabric channels first, then
        each device's DDR bank) — the counter-diff oracle's unit."""
        return (list(self._counter_banks)
                + [d.mem.counters for d in self.devices])

    def _mark(self, op: str, meta: str = ""):
        """Attribute the fabric transactions logged inside the block to
        one collective/transfer op (core/profiler.py); no-op unless
        constructed with ``profile=True``."""
        if not self.profile:
            return contextlib.nullcontext()
        return record_mark(self.marks, self.log, lambda: self.time, op,
                           "fabric", meta)

    # ----------------------------------------------------------- transfers
    def dev_copy(self, src_dev: int, dst_dev: int, name: str,
                 dst_name: Optional[str] = None) -> float:
        """Device-to-device transfer: read leg on the source port, write
        leg on the destination port, both congestion-timed."""
        dst_name = dst_name or name
        sbuf = self.devices[src_dev].mem.buffers[name]
        dbuf = self._dev_alloc(dst_dev, dst_name, sbuf.array.shape,
                               sbuf.array.dtype)
        eng = f"d{src_dev}->d{dst_dev}"
        with self._mark("dev_copy", name):
            if self.switch is None:
                done = self._issue_legs([
                    self._leg(self.ports[src_dev], eng, "read", sbuf.addr,
                              sbuf.nbytes, name),
                    self._leg(self.ports[dst_dev], eng, "write", dbuf.addr,
                              dbuf.nbytes, dst_name)])
            else:
                done = self._issue_journeys([self._journey(
                    src_dev, dst_dev, eng, [(sbuf.addr, sbuf.nbytes)],
                    [(dbuf.addr, dbuf.nbytes)], name, dst_name)])
            self.time = max(self.time, done)
        np.copyto(dbuf.array, sbuf.array)
        self._cover("dev_copy")
        return done

    def _shard_bounds(self, dim: int) -> List[Tuple[int, int]]:
        """Per-device [lo, hi) index bounds along a dim of size ``dim``
        (np.array_split semantics)."""
        sizes = [len(ix) for ix in np.array_split(np.arange(dim), self.n)]
        bounds, lo = [], 0
        for s in sizes:
            bounds.append((lo, lo + s))
            lo += s
        return bounds

    def scatter(self, name: str, axis: int = 0) -> float:
        """Split a host buffer across devices along ``axis`` (np.array_split
        bounds); every shard crosses the shared host channel (contending)
        plus its device port.  Host-side legs are logged at the shard's
        true (strided, for inner axes) byte runs."""
        hbuf = self.host.buffers[name]
        shards = np.array_split(hbuf.array, self.n, axis=axis)
        bounds = self._shard_bounds(hbuf.array.shape[axis])
        with self._mark("scatter", name):
            legs, journeys, moves = [], [], []
            for i, (sh, (lo, hi)) in enumerate(zip(shards, bounds)):
                buf = self._dev_alloc(i, name, sh.shape, hbuf.array.dtype)
                eng = f"h->d{i}"
                runs = [(hbuf.addr + off, nb) for off, nb in
                        shard_runs(hbuf.array.shape, hbuf.array.itemsize,
                                   axis, lo, hi)]
                if self.switch is None:
                    legs.append(self._leg(self.host_link, eng, "read", 0,
                                          0, name, runs=runs))
                    legs.append(self._leg(self.ports[i], eng, "write",
                                          buf.addr, sh.nbytes, name))
                else:
                    journeys.append(self._journey(
                        "h", i, eng, runs, [(buf.addr, sh.nbytes)],
                        name, name))
                moves.append((buf, sh))
            done = (self._issue_legs(legs) if self.switch is None
                    else self._issue_journeys(journeys))
            for buf, sh in moves:
                np.copyto(buf.array, sh)
            self.time = max(self.time, done)
        self._cover("scatter")
        return done

    def broadcast(self, name: str) -> float:
        """Replicate a host buffer onto every device; the N copies contend
        on the shared host channel."""
        hbuf = self.host.buffers[name]
        with self._mark("broadcast", name):
            legs, journeys, moves = [], [], []
            for i in range(self.n):
                buf = self._dev_alloc(i, name, hbuf.array.shape,
                                      hbuf.array.dtype)
                eng = f"h->d{i}"
                if self.switch is None:
                    legs.append(self._leg(self.host_link, eng, "read",
                                          hbuf.addr, hbuf.nbytes, name))
                    legs.append(self._leg(self.ports[i], eng, "write",
                                          buf.addr, buf.nbytes, name))
                else:
                    journeys.append(self._journey(
                        "h", i, eng, [(hbuf.addr, hbuf.nbytes)],
                        [(buf.addr, buf.nbytes)], name, name))
                moves.append(buf)
            done = (self._issue_legs(legs) if self.switch is None
                    else self._issue_journeys(journeys))
            for buf in moves:
                np.copyto(buf.array, hbuf.array)
            self.time = max(self.time, done)
        self._cover("broadcast")
        return done

    def gather(self, name: str, axis: int = 0) -> float:
        """Collect per-device shards of ``name`` back into the host buffer
        (allocated on first gather), concatenated along ``axis``."""
        shards = [self.devices[i].mem.buffers[name] for i in range(self.n)]
        out = (np.concatenate([b.array for b in shards], axis=axis)
               if self.n > 1 else shards[0].array.copy())
        hbuf = self.host.buffers.get(name)
        if hbuf is None:
            hbuf = self.host.alloc(name, out.shape, out.dtype)
        if hbuf.array.shape != out.shape:
            raise ValueError(
                f"gather({name!r}, axis={axis}): shards assemble to "
                f"{out.shape}, host buffer is {hbuf.array.shape}")
        bounds = self._shard_bounds(out.shape[axis])
        with self._mark("gather", name):
            legs, journeys = [], []
            for i, (b, (lo, hi)) in enumerate(zip(shards, bounds)):
                eng = f"d{i}->h"
                runs = [(hbuf.addr + off, nb) for off, nb in
                        shard_runs(out.shape, hbuf.array.itemsize, axis,
                                   lo, hi)]
                if self.switch is None:
                    legs.append(self._leg(self.ports[i], eng, "read",
                                          b.addr, b.nbytes, name))
                    legs.append(self._leg(self.host_link, eng, "write", 0,
                                          0, name, runs=runs))
                else:
                    journeys.append(self._journey(
                        i, "h", eng, [(b.addr, b.nbytes)], runs,
                        name, name))
            done = (self._issue_legs(legs) if self.switch is None
                    else self._issue_journeys(journeys))
            self.time = max(self.time, done)
        np.copyto(hbuf.array, out)
        self._cover("gather")
        return done

    # ---------------------------------------------------------- collective
    def all_reduce(self, name: str, op: str = "sum") -> float:
        """Ring all-reduce over every device's ``name`` buffer: N-1
        reduce-scatter steps then N-1 all-gather steps.  Each step moves
        one chunk per device to its ring neighbour, so every port carries
        a tx and an rx leg simultaneously — the legs contend on the port
        link, which is where the modeled inter-device stalls come from.

        The accumulation order per chunk is fixed by the ring, so results
        (and the transaction-log digest) reproduce exactly run-to-run.

        With a topology installed the collective instead runs
        **hierarchically** (``_all_reduce_routed``): members reduce onto
        their switch-local leader, leaders tree-reduce across the
        network, then the result tree- and locally-broadcasts back —
        the locality-exploiting shape the routed interconnect rewards.
        """
        if op not in ("sum", "max"):
            raise ValueError(f"unsupported all_reduce op {op!r}")
        bufs = [self.devices[i].mem.buffers[name] for i in range(self.n)]
        shape = bufs[0].array.shape
        for i, b in enumerate(bufs):
            if b.array.shape != shape:
                raise ValueError(
                    f"all_reduce({name!r}): device {i} shard {b.array.shape}"
                    f" != device 0 shard {shape}")
        self._cover("all_reduce")
        if self.n == 1:
            return self.time
        flat = [b.array.reshape(-1) for b in bufs]
        itemsize = bufs[0].array.itemsize
        combine = (lambda a, b: a + b) if op == "sum" else np.maximum
        if self.switch is not None:
            return self._all_reduce_routed(name, bufs, flat, combine)
        splits = np.array_split(np.arange(flat[0].size), self.n)
        bounds = [(int(ix[0]), int(ix[-1]) + 1) if len(ix) else (0, 0)
                  for ix in splits]

        def step(chunk_of: Callable[[int], int], reduce_leg: bool) -> None:
            sends, legs = [], []
            for i in range(self.n):
                j = (i + 1) % self.n
                lo, hi = bounds[chunk_of(i)]
                if lo == hi:        # degenerate chunk (more devices than
                    continue        # elements): nothing moves, no burst
                nbytes = (hi - lo) * itemsize
                eng = f"d{i}->d{j}"
                legs.append(self._leg(self.ports[i], eng, "read",
                                      bufs[i].addr + lo * itemsize,
                                      nbytes, name))
                legs.append(self._leg(self.ports[j], eng, "write",
                                      bufs[j].addr + lo * itemsize,
                                      nbytes, name))
                sends.append((j, lo, hi, flat[i][lo:hi].copy()))
            self.time = max(self.time, self._issue_legs(legs))
            for j, lo, hi, data in sends:
                if reduce_leg:
                    flat[j][lo:hi] = combine(flat[j][lo:hi], data)
                else:
                    flat[j][lo:hi] = data

        # one op mark per ring leg: the profiler's all_reduce attribution
        # (which reduce-scatter / all-gather step paid which stalls)
        for s in range(self.n - 1):             # reduce-scatter
            with self._mark("all_reduce", f"reduce_scatter[{s}]"):
                step(lambda i, s=s: (i - s) % self.n, True)
        for s in range(self.n - 1):             # all-gather
            with self._mark("all_reduce", f"all_gather[{s}]"):
                step(lambda i, s=s: (i + 1 - s) % self.n, False)
        return self.time

    def _all_reduce_routed(self, name: str, bufs, flat,
                           combine: Callable) -> float:
        """Hierarchical all_reduce over the switch graph, four phases:
        switch-local members reduce onto their group leader
        (``local_reduce``), leaders tree-reduce across the network with
        stride doubling (``tree_reduce``), the result walks back down the
        tree (``tree_bcast``), and leaders rebroadcast locally
        (``local_bcast``).  Every transfer is a full-buffer routed
        journey; within a round no device is both sender and receiver,
        and combines apply in pair-list order, so results and digests
        reproduce exactly."""
        groups = self.topology.groups()
        leaders = [g[0] for g in groups]

        def xfer(pairs: List[Tuple[int, int]], label: str,
                 reduce_leg: bool) -> None:
            if not pairs:
                return
            with self._mark("all_reduce", label):
                journeys = [self._journey(
                    s, d, f"d{s}->d{d}", [(bufs[s].addr, bufs[s].nbytes)],
                    [(bufs[d].addr, bufs[d].nbytes)], name, name)
                    for s, d in pairs]
                self.time = max(self.time, self._issue_journeys(journeys))
                for s, d in pairs:
                    if reduce_leg:
                        flat[d][:] = combine(flat[d], flat[s])
                    else:
                        flat[d][:] = flat[s]

        max_members = max(len(g) for g in groups)
        for r in range(1, max_members):         # members -> leaders
            xfer([(g[r], g[0]) for g in groups if len(g) > r],
                 f"local_reduce[{r - 1}]", True)
        stride, rnd = 1, 0                      # leaders tree-reduce
        while stride < len(leaders):
            xfer([(leaders[i], leaders[i - stride])
                  for i in range(stride, len(leaders), 2 * stride)],
                 f"tree_reduce[{rnd}]", True)
            stride *= 2
            rnd += 1
        rnd = 0                                 # tree broadcast back down
        while stride > 1:
            stride //= 2
            xfer([(leaders[i - stride], leaders[i])
                  for i in range(stride, len(leaders), 2 * stride)],
                 f"tree_bcast[{rnd}]", False)
            rnd += 1
        for r in range(1, max_members):         # leaders -> members
            xfer([(g[0], g[r]) for g in groups if len(g) > r],
                 f"local_bcast[{r - 1}]", False)
        return self.time

    def collect_replicated(self, name: str, src_dev: int = 0) -> float:
        """Pull one device's replica of ``name`` back to the host buffer
        (allocated on first collect) — the writeback leg for ops whose
        output is replicated rather than sharded (sharded_launch)."""
        buf = self.devices[src_dev].mem.buffers[name]
        if name not in self.host.buffers:
            self.host.alloc(name, buf.array.shape, buf.array.dtype)
        eng = f"d{src_dev}->h"
        with self._mark("collect_replicated", name):
            if self.switch is None:
                done = self._issue_legs([
                    self._leg(self.ports[src_dev], eng, "read", buf.addr,
                              buf.nbytes, name),
                    self._leg(self.host_link, eng, "write",
                              self.host.buffers[name].addr, buf.nbytes,
                              name)])
            else:
                done = self._issue_journeys([self._journey(
                    src_dev, "h", eng, [(buf.addr, buf.nbytes)],
                    [(self.host.buffers[name].addr, buf.nbytes)],
                    name, name)])
            self.time = max(self.time, done)
        np.copyto(self.host.buffers[name].array, buf.array)
        return done

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        """Whole-cluster snapshot at a transaction boundary
        (core/replay.py): every device bridge, the host staging DDR (whose
        transaction log IS the fabric log), every port arbiter, the shared
        host channel, the fabric clock, and the fabric-level fault plan."""
        return {
            "devices": [d.get_state() for d in self.devices],
            "host": self.host.get_state(),
            "host_link": self.host_link.get_state(),
            "ports": [p.get_state() for p in self.ports],
            "switch": (self.switch.get_state()
                       if self.switch is not None else None),
            "time": self.time,
            "fault_plan": (self.fault_plan.get_state()
                           if self.fault_plan is not None else None),
            "counters": [b.get_state() for b in self._counter_banks],
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        for d, s in zip(self.devices, state["devices"]):
            d.set_state(s)
        self.host.set_state(state["host"])
        self.host_link.set_state(state["host_link"])
        for p, s in zip(self.ports, state["ports"]):
            p.set_state(s)
        if self.switch is not None and state.get("switch") is not None:
            self.switch.set_state(state["switch"])
        self.time = state["time"]
        if state["fault_plan"] is not None:
            self.fault_plan.set_state(state["fault_plan"])
        for b, s in zip(self._counter_banks, state.get("counters") or []):
            b.set_state(s)

    # --------------------------------------------------------- diagnostics
    def link_stats(self) -> Dict[str, CongestionResult]:
        """Per-link Fig. 8 statistics: the host channel, every device
        port, and (routed fabrics) every switch port as ``sw:a->b``."""
        out = {"host": self.host_link.result()}
        for i, p in enumerate(self.ports):
            out[f"d{i}"] = p.result()
        if self.switch is not None:
            for label, link in self.switch.labeled_links():
                out[f"sw:{label}"] = link.result()
        return out

    def total_link_stall(self) -> float:
        return sum(sum(r.per_engine_stall.values())
                   for r in self.link_stats().values())

    def profiler(self, label: Optional[str] = None):
        """Data-movement profile of the whole cluster (core/profiler.py):
        one channel per fabric port plus the shared host channel and every
        device's DDR/CSR, with per-collective-leg op attribution."""
        from repro_torch.core.profiler import DataMovementProfiler
        return DataMovementProfiler(self, label=label or self.name)

    def device_congestion(self) -> Optional[CongestionResult]:
        """Merged per-device DDR-link statistics (engines prefixed
        ``d{i}/``), or None when the devices run congestion-free — so
        cross-scale sweeps keep reporting device-local memory stalls, not
        just fabric-link stalls."""
        per = [(i, r) for i, d in enumerate(self.devices)
               if (r := d.congestion_stats()) is not None]
        if not per:
            return None
        stall = {f"d{i}/{e}": v for i, r in per
                 for e, v in r.per_engine_stall.items()}
        busy = {f"d{i}/{e}": v for i, r in per
                for e, v in r.per_engine_busy.items()}
        makespan = max(r.makespan for _, r in per)
        util = sum(r.link_utilization for _, r in per) / len(per)
        timeline = [t for _, r in per for t in r.timeline]
        return CongestionResult(makespan=makespan, per_engine_stall=stall,
                                per_engine_busy=busy, link_utilization=util,
                                timeline=timeline)

    @property
    def violations(self) -> List[str]:
        out = list(self.log.violations)
        for i, d in enumerate(self.devices):
            out += [f"[d{i}] {v}" for v in d.log.violations]
        return out

    def fault_events(self) -> List:
        """Every fault injected anywhere in the cluster (fabric links plus
        per-device plans), for CellResult/fuzz auditing."""
        evs = list(self.fault_plan.events) if self.fault_plan else []
        for d in self.devices:
            if d.mem.fault_plan is not None:
                evs += list(d.mem.fault_plan.events)
        return evs

    def outputs(self) -> Dict[str, np.ndarray]:
        """Host-visible final state (the cross-scale equivalence surface)."""
        return {n: b.array.copy() for n, b in self.host.buffers.items()}

    def digest(self) -> str:
        """sha256 over the fabric log and every device log — the same-seed
        reproducibility witness for multi-device runs."""
        h = hashlib.sha256()
        h.update(self.log.digest().encode())
        for d in self.devices:
            h.update(d.log.digest().encode())
        return h.hexdigest()


def sharded_launch(fab: FabricCluster, op: str, backend: str, *,
                   inputs: Dict[str, np.ndarray],
                   output: Tuple[str, Tuple[int, ...], Any],
                   specs: Dict[str, Any],
                   burst_list: Optional[Callable] = None) -> None:
    """Run one op sharded across the cluster via sharding/specs.py layouts.

    ``specs`` maps buffer name -> ``sharding.specs.PartitionSpec``; dims
    named "fabric" are scattered across devices, unsharded inputs are
    broadcast, and the output is gathered back to the host.
    ``burst_list(dev, shapes)`` derives the device-local DMA burst list
    from that device's shard shapes.  Because the layouts never split a
    reduction axis, the gathered result is bit-identical to the
    single-device run.
    """
    for name, arr in inputs.items():
        arr = np.asarray(arr)
        if name not in fab.host.buffers:
            fab.host.alloc(name, arr.shape, arr.dtype)
        fab.host.host_write(name, arr)
        ax = fabric_shard_axis(specs[name])
        if ax is None:
            fab.broadcast(name)
        else:
            fab.scatter(name, axis=ax)

    oname, oshape, odtype = output
    oax = fabric_shard_axis(specs[oname])
    fab.alloc_sharded(oname, oshape, odtype, axis=oax)
    for i in range(fab.n):
        shapes = {n: fab.devices[i].mem.buffers[n].array.shape
                  for n in list(inputs) + [oname]}
        bl = ((lambda i=i, shapes=shapes: burst_list(i, shapes))
              if burst_list is not None else None)
        fab.launch(i, op, backend, list(inputs), [oname], burst_list=bl)

    if oax is not None:
        fab.gather(oname, axis=oax)
    else:                      # replicated output: device 0's copy crosses
        fab.collect_replicated(oname)
