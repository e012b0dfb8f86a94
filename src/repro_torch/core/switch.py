"""Modeled packet/flit switch layer (FireSim ``switch.cc``/``flit.h``
idiom on the congestion core).

A ``Topology`` (core/topology.py) is pure structure; this module is the
*state*: one ``SwitchPort`` per directed inter-switch link, each owning

* a ``LinkModel`` (core/congestion.py) — flit arbitration rides the same
  vectorized ``submit_batch`` pipeline as every other modeled channel,
  with its own seeded DoS stream, so per-hop stalls come out of the one
  arbitration core the differential tier already gates bit-exactly; and
* a **credit window** — credit-based flow control a la FireSim: the port
  models ``credits`` ingress-buffer slots downstream.  A flit batch may
  not enter the port until a slot frees, i.e. until the oldest
  still-in-flight flit among the last ``credits`` completes.  The wait is
  accounted separately (``credit_stall``) from arbitration stalls, and
  the window is part of ``get_state``/``set_state`` so time-travel replay
  restores flow-control state exactly.

Flit framing: a transfer leg reaching a switch hop is re-burst at
``topology.flit_bytes`` granularity (``BurstBatch.from_runs`` with the
flit step), so a 4 KB DMA leg contends at the switch as a train of flits
rather than one monolithic transfer — finer-grained interleaving than
the endpoint links' ``max_burst_bytes`` framing.

The credit window keeps only the ``credits`` *largest* in-flight
completion times: the gate is "wait until the oldest of the last
``credits`` flits completes", and any entry older than those can never
be the gate, so the truncation is exact, not an approximation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.congestion import CongestionConfig, LinkModel
from repro_torch.core.topology import Topology

__all__ = ["SwitchPort", "SwitchFabric"]

# switch-port DoS streams are decorrelated from the endpoint links, which
# use seed..seed+n_devices (core/fabric.py): a shared stream would stall
# every hop of a journey at the same draws — artificially coherent
# contention across the network
_PORT_SEED_BASE = 1009


class SwitchPort:
    """One switch egress port: flit arbitration + credit flow control."""

    def __init__(self, label: str, cfg: CongestionConfig,
                 credits: int) -> None:
        self.label = label
        self.link = LinkModel(cfg)
        self.credits = max(1, credits)
        # completion times of the newest `credits` flits through the port,
        # sorted ascending — the credit window
        self._inflight: List[float] = []
        self.credit_stall = 0.0
        self.credit_waits = 0
        self.credit_grants = 0

    def acquire(self, ready: float) -> float:
        """Earliest time a flit batch arriving at ``ready`` may enter the
        port: immediately if a credit is free, else when the oldest
        windowed flit completes.  Accounts the wait as credit stall."""
        win = self._inflight
        if len(win) >= self.credits and win[0] > ready:
            issue = win[0]
            self.credit_stall += issue - ready
            self.credit_waits += 1
            return issue
        self.credit_grants += 1
        return ready

    def release(self, completions: List[float]) -> None:
        """Fold a submitted batch's per-flit completion times into the
        credit window (keeping the ``credits`` largest is exact — see
        module docstring)."""
        merged = sorted(self._inflight + completions)
        self._inflight = merged[-self.credits:]

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        return {
            "link": self.link.get_state(),
            "inflight": list(self._inflight),
            "credit_stall": self.credit_stall,
            "credit_waits": self.credit_waits,
            "credit_grants": self.credit_grants,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.link.set_state(state["link"])
        self._inflight = list(state["inflight"])
        self.credit_stall = state["credit_stall"]
        self.credit_waits = state["credit_waits"]
        self.credit_grants = state["credit_grants"]


class SwitchFabric:
    """The routed interconnect's modeled state: every switch port of a
    ``Topology``, plus endpoint→route resolution (``'h'`` = the host
    staging DDR, attached at ``topology.host_attach``)."""

    def __init__(self, topology: Topology,
                 link_config: CongestionConfig) -> None:
        self.topology = topology
        self.ports = [
            SwitchPort(topology.edge_label(k),
                       dataclasses.replace(
                           link_config,
                           seed=link_config.seed + _PORT_SEED_BASE + k),
                       topology.credits)
            for k in range(len(topology.edges))]

    # -------------------------------------------------------------- routing
    def _switch_of(self, endpoint) -> int:
        if endpoint == "h":
            return self.topology.host_attach
        return self.topology.attach[endpoint]

    def route_ports(self, src, dst) -> List[SwitchPort]:
        """Switch ports along the static route between two endpoints
        (device index or ``'h'``), in traversal order."""
        return [self.ports[k] for k in self.topology.route_switches(
            self._switch_of(src), self._switch_of(dst))]

    # ---------------------------------------------------------- diagnostics
    def labeled_links(self) -> Iterator[Tuple[str, LinkModel]]:
        """(label, LinkModel) per port — profiler channels / link_stats."""
        for p in self.ports:
            yield p.label, p.link

    def total_credit_stall(self) -> float:
        return sum(p.credit_stall for p in self.ports)

    def port_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-hop readout: arbitration stall, credit stall, and traffic
        per switch port (bench_fabric_scaling's per-hop columns)."""
        out: Dict[str, Dict[str, float]] = {}
        for p in self.ports:
            r = p.link.result()
            out[p.label] = {
                "stall": sum(r.per_engine_stall.values()),
                "credit_stall": p.credit_stall,
                "busy": sum(r.per_engine_busy.values()),
                "flits": len(r.timeline),
            }
        return out

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        return {"ports": [p.get_state() for p in self.ports]}

    def set_state(self, state: Dict[str, Any]) -> None:
        for p, s in zip(self.ports, state["ports"]):
            p.set_state(s)
