"""Interconnect topologies for the routed fabric (core/switch.py).

The crossbar fabric (`FabricCluster` with ``topology=None``) attaches
every device port and the host channel to one implicit zero-hop switch —
inter-device stalls never depend on *where* a device sits.  FireSim's
scaling story is the opposite: cycle-accurate simulation reaches
thousands of nodes because the interconnect is a *modeled switched
network* (``switch.cc``/``flit.h``) whose contention structure survives
scale-down.  This module provides that structure:

* a ``Topology`` — switches, directed inter-switch links, device→switch
  attachments, and **static routing tables** (per-switch next-hop maps
  computed once by deterministic BFS), with
  ``route(src_dev, dst_dev) -> tuple of link indices``;
* builders for the three classic shapes: ``ring`` (one switch per
  device, shortest-way routing, clockwise on ties), ``torus2d``
  (near-square grid with wraparound, x-before-y dimension-order
  preference), and ``fat_tree`` (leaf switches holding ``leaf_width``
  devices under ``spines`` spine switches, static spine selection
  rotated per leaf so uplink load spreads without adaptive routing).

Topologies are pure descriptions — no queues, no clocks.  The modeled
switch state (per-port flit arbitration, credit windows) lives in
``core/switch.py``; ``core/fabric.py`` turns transfer legs into
multi-hop journeys along ``route()``.

The host staging DDR attaches to switch ``host_attach`` (switch 0 by
default), so scatter/gather traffic is placement-dependent exactly like
device-to-device traffic.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Tuple

__all__ = ["Topology", "ring", "torus2d", "fat_tree", "build_topology",
           "TOPOLOGY_KINDS"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A switched-interconnect shape: pure routing structure, no state.

    ``edges[k] = (a, b)`` is the k-th directed inter-switch link (one
    modeled switch egress port, ``core/switch.py``).  ``attach[i]`` is
    the switch device ``i`` hangs off.  ``flit_bytes`` is the framing
    granularity switch hops re-burst payloads at; ``credits`` is the
    per-port ingress-buffer depth for credit-based flow control.
    """
    kind: str
    n_devices: int
    n_switches: int
    attach: Tuple[int, ...]
    edges: Tuple[Tuple[int, int], ...]
    host_attach: int = 0
    flit_bytes: int = 256
    credits: int = 4

    def __post_init__(self):
        if len(self.attach) != self.n_devices:
            raise ValueError(
                f"attach maps {len(self.attach)} devices, topology has "
                f"{self.n_devices}")
        for s in (*self.attach, self.host_attach,
                  *(x for e in self.edges for x in e)):
            if not 0 <= s < self.n_switches:
                raise ValueError(f"switch id {s} out of range "
                                 f"[0, {self.n_switches})")
        # static routing tables: hop[s][t] = first link index on the
        # s -> t path, from one BFS per source switch.  Adjacency is
        # walked in link-declaration order, so builders control the
        # tie-break (clockwise for rings, x-before-y for tori, rotated
        # spine choice for fat trees) and routes are deterministic.
        adj: Dict[int, List[Tuple[int, int]]] = {
            s: [] for s in range(self.n_switches)}
        for k, (a, b) in enumerate(self.edges):
            adj[a].append((k, b))
        tables: List[Dict[int, int]] = []
        for src in range(self.n_switches):
            first: Dict[int, int] = {}
            q = deque([src])
            seen = {src}
            while q:
                s = q.popleft()
                for k, b in adj[s]:
                    if b in seen:
                        continue
                    seen.add(b)
                    # the first hop toward b is inherited from s (or is
                    # the link itself when s is the source)
                    first[b] = first.get(s, k)
                    q.append(b)
            tables.append(first)
        object.__setattr__(self, "_first_hop", tuple(tables))
        object.__setattr__(self, "_edge_by_pair",
                           {e: k for k, e in enumerate(self.edges)})

    # -------------------------------------------------------------- routing
    def route_switches(self, src_sw: int, dst_sw: int) -> Tuple[int, ...]:
        """Link indices along the static route between two switches
        (empty when they are the same switch)."""
        hops: List[int] = []
        s = src_sw
        while s != dst_sw:
            k = self._first_hop[s].get(dst_sw)
            if k is None:
                raise ValueError(
                    f"no route from switch {src_sw} to {dst_sw} "
                    f"({self.kind} topology is disconnected)")
            hops.append(k)
            s = self.edges[k][1]
        return tuple(hops)

    def route(self, src_dev: int, dst_dev: int) -> Tuple[int, ...]:
        """Link indices a device→device journey traverses (the hop list;
        empty when both devices share a switch)."""
        return self.route_switches(self.attach[src_dev],
                                   self.attach[dst_dev])

    def n_hops(self, src_dev: int, dst_dev: int) -> int:
        return len(self.route(src_dev, dst_dev))

    def groups(self) -> List[List[int]]:
        """Devices grouped by attachment switch (locality domains for the
        hierarchical all_reduce), in switch order, members sorted."""
        by_sw: Dict[int, List[int]] = {}
        for dev, sw in enumerate(self.attach):
            by_sw.setdefault(sw, []).append(dev)
        return [sorted(by_sw[sw]) for sw in sorted(by_sw)]

    def edge_label(self, k: int) -> str:
        a, b = self.edges[k]
        return f"sw{a}->sw{b}"


# ----------------------------------------------------------------- builders
def ring(n_devices: int, *, flit_bytes: int = 256,
         credits: int = 4) -> Topology:
    """One switch per device on a bidirectional ring.  Routing takes the
    shorter way around; on the even-ring tie the clockwise link is
    declared first, so ties break clockwise."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    edges: List[Tuple[int, int]] = []
    if n_devices > 1:
        for i in range(n_devices):
            edges.append((i, (i + 1) % n_devices))          # clockwise
            edges.append((i, (i - 1) % n_devices))          # counter
    return Topology("ring", n_devices, n_devices,
                    tuple(range(n_devices)), tuple(dict.fromkeys(edges)),
                    flit_bytes=flit_bytes, credits=credits)


def _grid(n: int) -> Tuple[int, int]:
    """Near-square rows x cols factorization of ``n`` (rows <= cols)."""
    r = int(n ** 0.5)
    while r > 1 and n % r:
        r -= 1
    return r, n // r


def torus2d(n_devices: int, *, rows: int = 0, flit_bytes: int = 256,
            credits: int = 4) -> Topology:
    """One switch per device on a 2D torus (near-square grid with
    wraparound links).  Per-switch link order is +x, -x, +y, -y, so the
    BFS routing tables prefer x-first dimension-order routes."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if rows:
        if n_devices % rows:
            raise ValueError(f"{n_devices} devices do not tile into "
                             f"{rows} rows")
        r, c = rows, n_devices // rows
    else:
        r, c = _grid(n_devices)
    edges: List[Tuple[int, int]] = []
    for y in range(r):
        for x in range(c):
            s = y * c + x
            for nb in (y * c + (x + 1) % c, y * c + (x - 1) % c,
                       ((y + 1) % r) * c + x, ((y - 1) % r) * c + x):
                if nb != s and (s, nb) not in edges:
                    edges.append((s, nb))
    return Topology("torus2d", n_devices, n_devices,
                    tuple(range(n_devices)), tuple(edges),
                    flit_bytes=flit_bytes, credits=credits)


def fat_tree(n_devices: int, *, leaf_width: int = 4, spines: int = 2,
             flit_bytes: int = 256, credits: int = 4) -> Topology:
    """Two-level fat tree: ``ceil(n/leaf_width)`` leaf switches each
    holding up to ``leaf_width`` devices, every leaf linked to every
    spine.  Leaf ``l`` declares its uplinks starting at spine
    ``l % spines``, so the static tables spread uplink load across
    spines by source leaf (FireSim-style static multi-root routing —
    no adaptive state)."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    leaf_width = max(1, leaf_width)
    n_leaves = -(-n_devices // leaf_width)
    spines = max(1, min(spines, n_leaves)) if n_leaves > 1 else 0
    attach = tuple(i // leaf_width for i in range(n_devices))
    edges: List[Tuple[int, int]] = []
    for leaf in range(n_leaves):
        for j in range(spines):
            sp = n_leaves + (leaf + j) % spines
            edges.append((leaf, sp))
            edges.append((sp, leaf))
    return Topology("fat_tree", n_devices, n_leaves + spines, attach,
                    tuple(dict.fromkeys(edges)),
                    flit_bytes=flit_bytes, credits=credits)


_BUILDERS = {"ring": ring, "torus2d": torus2d, "fat_tree": fat_tree}
TOPOLOGY_KINDS = tuple(_BUILDERS)


def build_topology(kind: str, n_devices: int, **kw) -> Topology:
    """Topology by name — the sweep-axis entry point
    (``CoVerifySession.add_sweep(..., topologies=("torus2d",))``)."""
    builder = _BUILDERS.get(kind)
    if builder is None:
        raise ValueError(f"unknown topology kind {kind!r} "
                         f"(known: {sorted(_BUILDERS)})")
    return builder(n_devices, **kw)
