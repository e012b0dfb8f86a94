"""Routed-interconnect tour (core/topology.py + core/switch.py), on the
PyTorch port (``repro_torch``).

Walks the three topology builders' static routing tables, then runs the
same sharded workload on a 1-device crossbar and an 8-device 2D-torus:
scatter, hierarchical all_reduce, gather — every transfer a multi-hop
journey of flit-framed, credit-flow-controlled switch hops — and reads
back the per-hop stall columns from the switch ports.

Every number below is a modeled cycle count (no wall time), so the
transcript is deterministic and the same on any device: it is the fenced
transcript of docs/topology.md, line for line.  The fabric moves host
numpy buffers only, so ``--device`` is checked and nothing runs there.

    PYTHONPATH=src python examples/topology_tour_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import FabricCluster, fat_tree, ring, torus2d
from repro_torch.core.congestion import CongestionConfig

LINK = CongestionConfig(link_bytes_per_cycle=64.0, base_latency=100.0,
                        max_burst_bytes=4096, dos_prob=0.05, seed=11)


def _show_route(name, topo, src, dst):
    sws = [f"sw{topo.attach[src]}"]
    sws += [f"sw{topo.edges[k][1]}" for k in topo.route(src, dst)]
    print(f"  {name:12s} {src} -> {dst} : {' -> '.join(sws)}"
          f"  ({topo.n_hops(src, dst)} switch hops)")


def _run(n, topology):
    fab = FabricCluster(n, topology=topology, link_config=LINK)
    x = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    fab.host.alloc("x", x.shape, np.float32)
    fab.host.host_write("x", x)
    fab.scatter("x", axis=0)
    for i in range(n):
        fab._dev_alloc(i, "grad", (16, 16), np.float32)
        fab.devices[i].mem.host_write(
            "grad", np.full((16, 16), float(i + 1), np.float32))
    fab.all_reduce("grad", "sum")
    fab.host.buffers["x"].array[:] = 0
    fab.gather("x", axis=0)
    return fab


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the run (cuda or cpu)")
    resolve_device(ap.parse_args(argv).device)
    print("routed interconnect tour: ring / 2D-torus / fat-tree")
    print("\nstatic routes (deterministic BFS, declaration-order "
          "tie-breaks):")
    _show_route("ring(8)", ring(8), 0, 4)        # clockwise on the tie
    _show_route("torus2d(8)", torus2d(8), 0, 5)  # x before y
    _show_route("fat_tree(8)", fat_tree(8), 0, 7)  # leaf -> spine -> leaf

    print("\nsame workload, crossbar oracle vs routed 2D-torus "
          "(DoS on every link,")
    print("credits=1 so the flit trains exercise credit flow control):")
    oracle = _run(1, None)
    fab = _run(8, torus2d(8, credits=1))
    same = np.array_equal(oracle.host.host_read("x"),
                          fab.host.host_read("x"))
    print(f"  gathered result bit-identical to 1-device oracle: {same}")
    print(f"  modeled fabric cycles: crossbar {oracle.time:.0f}, "
          f"torus {fab.time:.0f}")
    print(f"  grad after hierarchical all_reduce (want {sum(range(1, 9))}"
          f".0): {fab.devices[3].mem.buffers['grad'].array[0, 0]}")

    stats = fab.switch.port_stats()
    hot = sorted(stats.items(), key=lambda kv: (-kv[1]["stall"],
                                                -kv[1]["flits"], kv[0]))
    print(f"\n  per-hop stall columns ({len(stats)} switch ports, "
          f"6 hottest):")
    print("    port        flits   busy  stall  credit_stall")
    for label, s in hot[:6]:
        print(f"    {label:10s} {s['flits']:6.0f} {s['busy']:6.0f} "
              f"{s['stall']:6.0f} {s['credit_stall']:13.0f}")
    total = sum(s["stall"] for s in stats.values())
    credit = fab.switch.total_credit_stall()
    print(f"    total arbitration stall {total:.0f}, "
          f"credit stall {credit:.0f}")

    fab2 = _run(8, torus2d(8, credits=1))
    print(f"\n  run-to-run digest identical: "
          f"{fab2.digest() == fab.digest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
