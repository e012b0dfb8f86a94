"""Fabric scaling on the PyTorch port (``repro_torch``): the multi-device
co-verification sweep across device counts AND interconnect topologies
(core/fabric.py + core/topology.py; the FireSim-style scale-out lane).
Every modeled device runs its launches on the one ``--device``.

For each (device count, topology) point the same systolic-matmul cell
runs sharded across a FabricCluster through the CoVerifySession
``devices=``/``topologies=`` axes, reporting

* modeled fabric cycles (scatter/broadcast/launch/gather through the
  per-port links + shared host channel, congestion-arbitrated),
* modeled link stall cycles (the Fig. 8 series, now inter-device),
* routed runs' switch-hop stalls: total flit-arbitration stall summed
  over switch ports plus the single hottest port, and
* wall-clock seconds per cell,

with every gathered result equivalence-checked against the 1-device
crossbar oracle (bit-identical by construction — reduction axes are
never split, and routing reshapes timing, never data).  After the main
table a ``hop`` section breaks the routed cells down per switch port —
the per-hop stall columns that expose WHERE a topology congests.

Two repairs of the reference's full mode, which stops on each: a routed
cell must report switch ports wherever its topology has inter-switch
links (a 4-device fat tree is one leaf switch and has none), and the
head-sharded attention runs at the device counts that divide its 8 heads
(1, 4 and 8 of 1/4/8/16; a shard of a head does not exist).

Quick mode (benchmarks/run_torch.py) keeps the 1/2/4-device crossbar sweep
plus one routed 4-device torus; full mode sweeps ring / 2D-torus /
fat-tree at 4/8/16 devices and adds the head-sharded flash-attention op.

    PYTHONPATH=src:. python benchmarks/bench_fabric_scaling_torch.py \
        [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core import FABRIC_LINK, CoVerifySession

LINK = FABRIC_LINK
MM_SIZE = 128
FA_CFG = {"batch": 1, "heads": 8, "seq": 64, "dim": 16}
TOPOLOGIES = (None, "ring", "torus2d", "fat_tree")


def _sweep(op, firmware, fabric_firmware, backends, table, config,
           devices, topologies):
    sess = CoVerifySession(firmware, fabric_firmware=fabric_firmware,
                           link_config=LINK)
    sess.register_op(op, **table)
    sess.add_sweep(op, backends, [config], devices=devices,
                   topologies=topologies)
    return sess.run(max_workers=4)


def switch_links(kind: str, devices: int) -> int:
    """Inter-switch links of a routed topology: none where every device
    hangs off one switch (a fat tree of at most ``leaf_width`` devices),
    and then a routed cell has no switch port to report."""
    from repro_torch.core import build_topology
    return len(build_topology(kind, devices).edges)


def _hop_stalls(result):
    """(total, hottest) switch-port flit-arbitration stall of one routed
    cell, from the ``sw:*`` entries of its link_stats."""
    per_port = {name: sum(r.per_engine_stall.values())
                for name, r in (result.links or {}).items()
                if name.startswith("sw:")}
    return per_port, sum(per_port.values()), max(per_port.values(),
                                                 default=0.0)


def run(quick: bool = True, device="cuda") -> list[str]:
    from repro_torch.kernels.flash_attention import sweep as fa_sweep
    from repro_torch.kernels.systolic_matmul import sweep as mm_sweep

    devices = (1, 2, 4) if quick else (1, 4, 8, 16)
    topologies = (None, "torus2d") if quick else TOPOLOGIES
    rows = ["case,op,backend,devices,topology,bridge_cycles,"
            "link_stall_cycles,hop_stall_cycles,max_hop_stall,wall_s,"
            "equivalent"]
    hop_rows = ["hop,op,backend,devices,topology,port,stall_cycles,"
                "busy_cycles"]
    jobs = [("mm", mm_sweep.matmul_firmware,
             mm_sweep.matmul_fabric_firmware,
             ("oracle", "compiled") if quick else ("oracle", "interpret",
                                                   "compiled"),
             mm_sweep.matmul_backends(tile=32, device=device),
             {"size": MM_SIZE})]
    if not quick:
        jobs.append(("fa", fa_sweep.flash_firmware,
                     fa_sweep.flash_fabric_firmware,
                     ("oracle", "interpret"),
                     fa_sweep.flash_backends(device=device), FA_CFG))
    for op, fw, ffw, backends, table, config in jobs:
        heads = config.get("heads")
        counts = tuple(n for n in devices if not heads or heads % n == 0)
        report = _sweep(op, fw, ffw, backends, table, config, counts,
                        topologies)
        assert report.passed, report.summary()
        for r in sorted(report.cells,
                        key=lambda r: (r.cell.backend, r.cell.devices,
                                       r.cell._topo_kind or "")):
            topo = r.cell._topo_kind or "crossbar"
            per_port, hop_total, hop_max = _hop_stalls(r)
            if r.cell.devices > 1:
                assert r.link_stall > 0, \
                    f"no modeled link stalls at {r.cell.label}"
            if r.cell.topology is not None and \
                    switch_links(topo, r.cell.devices):
                assert per_port, f"no switch ports at {r.cell.label}"
            rows.append(f"fabric,{op},{r.cell.backend},{r.cell.devices},"
                        f"{topo},{r.bridge_time:.0f},{r.link_stall:.0f},"
                        f"{hop_total:.0f},{hop_max:.0f},{r.seconds:.3f},"
                        f"{report.passed}")
            for port, stall in sorted(per_port.items()):
                busy = sum(r.links[port].per_engine_busy.values())
                hop_rows.append(
                    f"hop,{op},{r.cell.backend},{r.cell.devices},{topo},"
                    f"{port[3:]},{stall:.0f},{busy:.0f}")
    return rows + hop_rows


def run_full(device="cuda") -> list[str]:
    return run(quick=False, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("\n".join(run(quick=not args.full, device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
