"""The programs behind the committed golden traces (``tests/golden/``), run
on the port.

Each program builds its target from the traces' frozen seeds and makes the
same calls, in the same order, as the reference's recorded golden program;
a trace file is the canonical rendering of the target's logs (a header
line before each log of a fabric or a serving cluster), a counters file
the canonical rendering of its counter banks.  The programs run directly,
with no replay recording: a recording only observes the calls it makes.
Token values and DDR contents never enter a trace, so the files are the
same whichever ``device`` runs the backends or the served model.
"""
from __future__ import annotations

import functools
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
from repro_torch.serving.cluster import ClusterServingEngine

Device = Union[str, torch.device]

# frozen stimulus parameters: changing any of these invalidates the traces
SINGLE_CONG = CongestionConfig(dos_prob=0.05, seed=7)
GOLDEN_LINK = CongestionConfig(link_bytes_per_cycle=64.0, base_latency=100.0,
                               max_burst_bytes=4096, dos_prob=0.05, seed=11)
FUZZ_SEED = 5
STORM_SEED = 0                  # cluster storm prompt seed
OPEN_LOOP_SEED = 23             # open-loop serving arrival + fault seed


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


def storm_requests():
    """The cluster storm's six requests: (rid, prompt, max_new_tokens)."""
    rng = np.random.default_rng(STORM_SEED)
    return [(rid, [int(t) for t in rng.integers(0, 100, 6 + rid % 5)],
             2 + rid % 3) for rid in range(6)]


@functools.lru_cache(maxsize=4)
def _smoke_model(device: str):
    """The served model of the cluster goldens: llama3.2-1b at smoke size,
    bf16 weights drawn from seed 0 on ``device`` (weight and token values
    never enter a trace)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models.transformer import RunFlags, init_params
    cfg = smoke(get_config("llama3.2-1b"))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16)
    return cfg, params, RunFlags(attn_impl="chunked", q_chunk=16,
                                 kv_chunk=16)


def drive_storm(eng, reqs, max_ticks: int = 10_000) -> None:
    """The storm program (``core/replay.py::serving_storm_program``), run
    directly: each request's prompt poked into ``prompt_in``, SUBMIT_* and
    DOORBELL written through the CSRs, then scheduler ticks until the
    cluster drains."""
    for rid, prompt, mx in reqs:
        data = np.asarray(prompt, np.int32)
        eng.mem.buffers["prompt_in"].array[:data.size] = data
        for name, val in (("SUBMIT_ID", rid), ("SUBMIT_LEN", len(prompt)),
                          ("SUBMIT_MAXNEW", mx), ("DOORBELL", 1)):
            eng.csr.fb_write_32(eng.csr.addr_of(name), int(val))
    for _ in range(max_ticks):
        if not eng._n_pending() and not eng._n_active():
            break
        eng.step()


def cluster_serving_storm(device: Device = "cuda") -> ClusterServingEngine:
    """Fixed cluster-serving storm: 6 requests round-robined across 2
    device-local engines behind one CSR front-end, prompt/token DMA
    contending on the shared host channel."""
    cfg, params, flags = _smoke_model(str(torch.device(device)))
    clu = ClusterServingEngine(cfg, params, n_devices=2, max_slots=2,
                               max_len=32, prompt_pad=8, flags=flags,
                               device=device)
    drive_storm(clu, storm_requests())
    return clu


def open_loop_trace():
    """The open-loop golden's arrivals: a burst of up to 8 lands about 2
    requests a device, and every request reserves at least 2 of its
    engine's 3 pages, so the second concurrent request a device defers."""
    from repro_torch.serving.arrivals import bursty_trace
    return bursty_trace(OPEN_LOOP_SEED, n_requests=10, burst_size=8,
                        gap_in_burst=10.0, gap_between=900.0,
                        prompt_lens=(3, 10), max_new=(1, 4))


def cluster_open_loop_serving(device: Device = "cuda"
                              ) -> ClusterServingEngine:
    """Fixed open-loop serving run: the bursty arrival trace through
    continuous batching on a 4-device ring-routed cluster with per-device
    KV page pools (3 pages of 8 entries) and a fault plan perturbing the
    host-channel DMA."""
    from repro_torch.serving.arrivals import run_open_loop
    cfg, params, flags = _smoke_model(str(torch.device(device)))
    clu = ClusterServingEngine(
        cfg, params, n_devices=4, max_slots=2, max_len=32, prompt_pad=8,
        flags=flags, topology="ring", batching="continuous", kv_pages=3,
        kv_page_size=8, fault_plan=FaultPlan(seed=OPEN_LOOP_SEED),
        device=device)
    run_open_loop(clu, open_loop_trace())
    return clu


PROGRAMS: Dict[str, Callable[[Device], object]] = {
    "single_device_launch": single_device_launch,
    "fabric_all_reduce": fabric_all_reduce,
    "fabric_batched_launch": fabric_batched_launch,
    "fabric_torus_all_reduce": fabric_torus_all_reduce,
    "faulty_fuzz": faulty_fuzz,
    "cluster_serving_storm": cluster_serving_storm,
    "cluster_open_loop_serving": cluster_open_loop_serving,
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
    if isinstance(target, ClusterServingEngine):
        lines = ["# cluster front log"] + target.log.canonical()
        for i, e in enumerate(target.engines):
            lines += [f"# engine {i} log"] + e.mem.log.canonical()
        return lines
    return target.log.canonical()


def counter_lines(target) -> List[str]:
    """The counters-file rendering of a finished golden target."""
    return [ln for bank in counter_banks(target) for ln in bank.canonical()]
