"""The programs behind the committed golden traces (``tests/golden/``), run
on the port.

Each program builds its target from the traces' frozen seeds and makes the
same calls, in the same order, as the reference's recorded golden program;
a trace file is the canonical rendering of the target's logs (a header
line before each log of a fabric), a counters file the canonical rendering
of its counter banks.  The programs run directly, with no replay
recording: a recording only observes the calls it makes.  Token values and
DDR contents never enter a trace, so the files are the same whichever
``device`` runs the backends.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np
import torch

from repro_torch.core.bridge import FireBridge
from repro_torch.core.congestion import CongestionConfig
from repro_torch.core.counters import counter_banks
from repro_torch.core.fabric import FabricCluster
from repro_torch.core.fuzz import FaultPlan, ProtocolFuzzer
from repro_torch.kernels.systolic_matmul import ops as mm_ops
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                       matmul_firmware)

Device = Union[str, torch.device]

# frozen stimulus parameters: changing any of these invalidates the traces
SINGLE_CONG = CongestionConfig(dos_prob=0.05, seed=7)
GOLDEN_LINK = CongestionConfig(link_bytes_per_cycle=64.0, base_latency=100.0,
                               max_burst_bytes=4096, dos_prob=0.05, seed=11)
FUZZ_SEED = 5


def single_device_launch(device: Device = "cuda") -> FireBridge:
    """Fixed-seed single-device matmul launch under online congestion."""
    fb = FireBridge(congestion=SINGLE_CONG)
    fb.register_op("mm", **matmul_backends(tile=16, device=device, jit=False))
    matmul_firmware(fb, "mm", "oracle", size=32, tile=16)
    return fb


def fabric_all_reduce(device: Device = "cuda") -> FabricCluster:
    """Fixed-seed 4-device ring all_reduce over the modeled fabric."""
    fab = FabricCluster(4, link_config=GOLDEN_LINK)
    for i in range(4):
        fab.devices[i].mem.alloc("grad", (16, 16), np.float32)
        fab.devices[i].mem.host_write(
            "grad", np.full((16, 16), float(i + 1), np.float32))
    fab.all_reduce("grad", "sum")
    return fab


def faulty_fuzz(device: Device = "cuda") -> FireBridge:
    """Fixed-seed fault-plan-active bridge fuzz scenario, oracle backend:
    the first scenario of a bridge-only ``ProtocolFuzzer`` run as its
    ``_run_bridge`` runs the oracle (same plan fork, buffers, burst
    lists)."""
    fz = ProtocolFuzzer(seed=FUZZ_SEED, layers=("bridge",),
                        bridge_ops=(3, 4), device=device)
    scn = fz.scenario(0)
    plan = fz.plan.fork(f"{scn.label}/oracle", scenario=scn.index)
    fb = FireBridge(congestion=fz.congestion, fault_plan=plan)
    fb.register_op("mm", **fz._matmul_table())
    for j, (_, size) in enumerate(scn.ops):
        rng = np.random.default_rng(size * 1009 + j)
        a = rng.normal(size=(size, size)).astype(np.float32)
        b = rng.normal(size=(size, size)).astype(np.float32)
        fb.mem.alloc(f"a{j}", a.shape, np.float32)
        fb.mem.alloc(f"b{j}", b.shape, np.float32)
        fb.mem.alloc(f"c{j}", (size, size), np.float32)
        fb.mem.host_write(f"a{j}", a)
        fb.mem.host_write(f"b{j}", b)
        fb.launch("mm", "oracle", [f"a{j}", f"b{j}"], [f"c{j}"],
                  engine="mm",
                  burst_list=lambda s=size: mm_ops.transactions(
                      s, s, s, bm=fz.TILE, bn=fz.TILE, bk=fz.TILE,
                      dtype_bytes=4))
    return fb


def fabric_batched_launch(device: Device = "cuda") -> FabricCluster:
    """Fixed-seed 3-device program on the batched same-launch fabric-leg
    path, DoS on the links and a fault plan perturbing the batches:
    contiguous (axis 0) and strided (axis 1) scatters, a broadcast,
    per-device launches under device-local congestion, a gather, a
    cross-device copy and a replicated collect."""
    fab = FabricCluster(3, congestion=SINGLE_CONG, link_config=GOLDEN_LINK,
                        fault_plan=FaultPlan(seed=13))
    fab.register_op("mm", **matmul_backends(tile=16, device=device,
                                            jit=False))
    rng = np.random.default_rng(21)
    act = rng.normal(size=(48, 48)).astype(np.float32)
    wts = rng.normal(size=(48, 48)).astype(np.float32)
    for name, arr in (("act", act), ("act2", act), ("wts", wts)):
        fab.host.alloc(name, arr.shape, np.float32)
        fab.host.host_write(name, arr)
    fab.scatter("act", axis=0)
    fab.scatter("act2", axis=1)
    fab.broadcast("wts")
    for i in range(3):
        fab.devices[i].mem.alloc("out", (16, 48), np.float32)
        fab.launch(i, "mm", "oracle", ["act", "wts"], ["out"])
    fab.gather("out", axis=0)
    fab.dev_copy(0, 2, "act", dst_name="act_copy")
    fab.collect_replicated("wts")
    return fab


def fabric_torus_all_reduce(device: Device = "cuda") -> FabricCluster:
    """Fixed-seed 8-device 2D-torus program on the routed fabric path:
    scatter / broadcast journeys from the host attachment, the
    hierarchical all_reduce, a multi-hop dev_copy, a gather and a
    replicated collect, DoS on every link and a fault plan perturbing the
    hop batches."""
    fab = FabricCluster(8, link_config=GOLDEN_LINK,
                        fault_plan=FaultPlan(seed=13), topology="torus2d")
    rng = np.random.default_rng(29)
    act = rng.normal(size=(32, 32)).astype(np.float32)
    fab.host.alloc("act", act.shape, np.float32)
    fab.host.host_write("act", act)
    fab.scatter("act", axis=0)
    fab.host.alloc("wts", (16, 16), np.float32)
    fab.host.host_write("wts", rng.normal(size=(16, 16)).astype(np.float32))
    fab.broadcast("wts")
    for i in range(8):
        fab.devices[i].mem.alloc("grad", (16, 16), np.float32)
        fab.devices[i].mem.host_write(
            "grad", np.full((16, 16), float(i + 1), np.float32))
    fab.all_reduce("grad", "sum")
    fab.dev_copy(0, 5, "grad", dst_name="grad_copy")      # x + y hops
    fab.gather("act", axis=0)
    fab.collect_replicated("wts")
    return fab


PROGRAMS: Dict[str, Callable[[Device], object]] = {
    "single_device_launch": single_device_launch,
    "fabric_all_reduce": fabric_all_reduce,
    "fabric_batched_launch": fabric_batched_launch,
    "fabric_torus_all_reduce": fabric_torus_all_reduce,
    "faulty_fuzz": faulty_fuzz,
}
# the committed counter streams (``<name>.counters``)
COUNTER_TRACES = ("single_device_launch", "fabric_torus_all_reduce")


def trace_lines(target) -> List[str]:
    """The trace-file rendering of a finished golden target."""
    if isinstance(target, FabricCluster):
        lines = ["# fabric interconnect log"] + target.log.canonical()
        for i, d in enumerate(target.devices):
            lines += [f"# device {i} log"] + d.log.canonical()
        return lines
    return target.log.canonical()


def counter_lines(target) -> List[str]:
    """The counters-file rendering of a finished golden target."""
    return [ln for bank in counter_banks(target) for ln in bank.canonical()]
