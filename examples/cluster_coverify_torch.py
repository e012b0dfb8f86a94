"""Multi-device co-verification walkthrough (core/fabric.py): the same
sweep cell at 1/2/4 devices, cross-scale equivalence, modeled link
stalls, same-seed digest reproducibility, fabric coverage, and (with
--serve) the cluster serving engine under a request storm.  On the
PyTorch port (``repro_torch``): the modeled devices are one ``--device``.

    PYTHONPATH=src python examples/cluster_coverify_torch.py
    PYTHONPATH=src python examples/cluster_coverify_torch.py --devices 1,2,4 --size 128
    PYTHONPATH=src python examples/cluster_coverify_torch.py --serve
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (FABRIC_LINK, CoVerifySession, CoverageModel,
                              FabricCluster, FaultPlan)
from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                 matmul_fabric_firmware,
                                                 matmul_firmware)

LINK = FABRIC_LINK


def devices_sweep(devices, size, backends, device="cuda"):
    print(f"== devices sweep: systolic matmul {size}x{size} across "
          f"{devices} device(s) x {backends} ==")
    sess = CoVerifySession(matmul_firmware,
                           fabric_firmware=matmul_fabric_firmware,
                           link_config=LINK)
    sess.register_op("mm", **matmul_backends(tile=32, device=device))
    sess.add_sweep("mm", backends, [{"size": size}], devices=devices)
    report = sess.run(max_workers=4)
    s = report.summary()
    print(f"  {s['cells']} cells, {s['groups']} equivalence group(s), "
          f"{s['wall_seconds']:.2f}s wall -> "
          f"{'PASS' if report.passed else 'FAIL: ' + str(s['failures'])}")
    for line in report.scaling():
        print(f"  {line}")
    (eq,) = report.equivalence.values()
    print(f"  cross-scale equivalence: {eq}")
    by = {r.cell.group_member: r for r in report.cells}
    for be in backends:
        for n in devices:
            if n == 1:
                continue
            same = np.array_equal(by[be].outputs["c"],
                                  by[f"{be}@{n}dev"].outputs["c"])
            print(f"  {be}: {n}-device gather bit-identical to "
                  f"single-device: {same}")
    return report


def digest_reproducibility(size, seed, device="cuda"):
    def one():
        fab = FabricCluster(4, link_config=LINK,
                            fault_plan=FaultPlan(seed))
        fab.register_op("mm", **matmul_backends(tile=32, device=device,
                                                jit=False))
        matmul_fabric_firmware(fab, "mm", "oracle", size=size, tile=32)
        fab.all_reduce("c")     # exercise the collective too
        return fab

    a, b = one(), one()
    print(f"\n== same-seed reproducibility (seed {seed}) ==")
    print(f"  run 1 fabric digest: {a.digest()[:16]}")
    print(f"  run 2 fabric digest: {b.digest()[:16]}")
    if a.digest() != b.digest():
        sys.exit("fabric digest reproducibility broken")
    print(f"  IDENTICAL ({len(a.log.txs)} fabric transactions, "
          f"{len(a.log.faults)} injected faults audited, "
          f"{a.total_link_stall():.0f} link stall cycles)")


def fabric_coverage(size, device="cuda"):
    cov = CoverageModel()
    fab = FabricCluster(4, link_config=LINK, coverage=cov)
    fab.register_op("mm", **matmul_backends(tile=32, device=device,
                                            jit=False))
    matmul_fabric_firmware(fab, "mm", "oracle", size=size, tile=32)
    fab.all_reduce("c")
    fab.dev_copy(0, 1, "b", dst_name="b_copy")
    print("\n== fabric coverage ==")
    print(cov.report(groups=["fabric", "burst_size", "congestion"]))


def serving_params(cfg, device):
    """The storm's bf16 weights, drawn from seed 0 on ``device``."""
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       dtype=torch.bfloat16)


def serving_storm(device="cuda"):
    from repro_torch.configs import get_config, smoke
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import ClusterServingEngine, ServingEngine

    print("\n== cluster serving storm (2 devices, one CSR front-end) ==")
    cfg = smoke(get_config("llama3.2-1b"))
    params = serving_params(cfg, device)
    flags = RunFlags(attn_impl="chunked", q_chunk=16, kv_chunk=16)
    single = ServingEngine(cfg, params, max_slots=4, max_len=64,
                           flags=flags, device=device)
    clu = ClusterServingEngine(cfg, params, n_devices=2, max_slots=2,
                               max_len=64, flags=flags, device=device)
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(5, 30)))
               for rid in range(8)}

    def storm(e):
        for rid, p in prompts.items():
            e.mem.buffers["prompt_in"].array[:len(p)] = p
            e.csr.fb_write_32(e.csr.addr_of("SUBMIT_ID"), rid)
            e.csr.fb_write_32(e.csr.addr_of("SUBMIT_LEN"), len(p))
            e.csr.fb_write_32(e.csr.addr_of("SUBMIT_MAXNEW"), 6)
            e.csr.fb_write_32(e.csr.addr_of("DOORBELL"), 1)
        e.run_until_done()

    storm(single)
    storm(clu)
    parity = all(single.requests[r].out_tokens == clu.requests[r].out_tokens
                 for r in prompts)
    st = clu.fabric_stats()
    print(f"  completed: single {single.completed}, "
          f"cluster {clu.completed} (placement "
          f"{dict(sorted(clu.placement.items()))})")
    print(f"  token parity vs single engine: {parity}")
    print(f"  host-channel stalls: "
          f"{ {k: round(v) for k, v in sorted(st.per_engine_stall.items())} }")
    if not parity or clu.completed != len(prompts):
        sys.exit("cluster serving diverged from the single engine")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backends", default="oracle,interpret,compiled")
    ap.add_argument("--serve", action="store_true",
                    help="also run the cluster serving storm (builds a "
                         "smoke model; slower)")
    ap.add_argument("--device", default="cuda",
                    help="device the backends and the model run on "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    devices = tuple(int(d) for d in args.devices.split(","))
    backends = tuple(b for b in args.backends.split(",") if b)

    report = devices_sweep(devices, args.size, backends, device)
    digest_reproducibility(args.size, args.seed, device)
    fabric_coverage(args.size, device)
    if args.serve:
        serving_storm(device)
    if not report.passed:
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
