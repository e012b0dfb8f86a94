"""Randomized fault-injection co-verification — the paper's randomized
memory bridge + register-level protocol testing (§IV) as a CLI.

Runs N seeded fault scenarios round-robin across the enabled layers
(bridge DMA faults with three-backend differential checking, register
protocol storms against a golden shadow model, randomized serving submit
streams), audits every injected fault, then re-runs the same seed and
checks the transaction-log digest reproduces bit-for-bit.  On the PyTorch
port (``repro_torch``): the backends and the serving engine run on
``--device``.

    PYTHONPATH=src python examples/fuzz_protocol_torch.py --seed 0 --faults 200
    PYTHONPATH=src python examples/fuzz_protocol_torch.py --layers bridge,registers,serving
    PYTHONPATH=src python examples/fuzz_protocol_torch.py --inject-bug --shrink

``--shrink`` minimizes the first failing scenario to its shortest failing
op prefix; ``--inject-bug`` plants a known divergence in the interpret
backend so the shrink flow can be demonstrated on a healthy tree.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.core import ProtocolFuzzer
from repro_torch.core.fuzz import planted_bug_table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", type=int, default=200,
                    help="number of randomized fault scenarios")
    ap.add_argument("--layers", default="bridge,registers,serving",
                    help="comma-separated subset of bridge,registers,serving")
    ap.add_argument("--shrink", action="store_true",
                    help="minimize the first failing scenario to its "
                         "shortest failing op prefix")
    ap.add_argument("--inject-bug", action="store_true",
                    help="plant a known interpret-backend bug (demo)")
    ap.add_argument("--skip-repro-check", action="store_true",
                    help="skip the same-seed second pass")
    ap.add_argument("--coverage-report", default=None, metavar="PATH",
                    help="write the functional-coverage bin report "
                         "(core/coverage.py) to this file")
    ap.add_argument("--device", default="cuda",
                    help="device the backends run on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    layers = tuple(s for s in args.layers.split(",") if s)
    fz = ProtocolFuzzer(
        seed=args.seed, layers=layers, device=device,
        mm_table=planted_bug_table(device=device) if args.inject_bug
        else None)

    t0 = time.perf_counter()
    report = fz.run(args.faults)
    dt = time.perf_counter() - t0
    s = report.summary()
    print(f"fuzz: {s['scenarios']} scenarios in {dt:.1f}s "
          f"({s['scenarios'] / dt:.1f}/s) across {s['by_layer']}")
    print(f"  faults injected ({sum(s['faults'].values())} total):")
    for k, v in sorted(s["faults"].items()):
        print(f"    {k:20s} {v}")
    print(f"  violations audited: {s['violations_audited']}   "
          f"transactions logged: {s['transactions']}")
    print(f"  transaction-log digest: {report.digest[:16]}")
    # functional coverage: the acceptance gate is 100% of the protocol
    # bins; the report names every hole it finds
    groups = ["protocol", "burst_size", "congestion", "fault_kind"]
    if "serving" in layers:
        groups.append("serving")
    cov_text = report.coverage.report(groups=groups)
    print("  " + cov_text.replace("\n", "\n  "))
    if args.coverage_report:
        Path(args.coverage_report).write_text(
            report.coverage.report() + "\n")
        print(f"  coverage report written to {args.coverage_report}")
    print(f"  result: {'PASS' if report.passed else 'FAIL'}")
    if not report.coverage.covered("protocol"):
        print(f"  WARNING: uncovered protocol bins: "
              f"{report.coverage.holes('protocol')}")

    if not report.passed:
        for r in report.failures()[:4]:
            print(f"    scn{r.index}[{r.layer}]: {r.failures[0][:160]}")
        if args.shrink:
            fail = report.failures()[0]
            scn = fz.scenario(fail.index)
            print(f"\nshrinking scn{scn.index} "
                  f"({len(scn.ops)} ops) to shortest failing prefix...")
            sub, res = fz.shrink(scn)
            print(f"  minimal repro: {len(sub.ops)} op(s)")
            for op in sub.ops:
                print(f"    {op}")
            print(f"  failure: {res.failures[0][:200]}")
            print(f"  re-run: PYTHONPATH=src python examples/"
                  f"fuzz_protocol_torch.py --seed {args.seed} "
                  f"--faults {fail.index + 1} --layers {fail.layer}")

    if not args.skip_repro_check:
        report2 = fz.run(args.faults)
        ok = report2.digest == report.digest
        print(f"\nseeded reproducibility (seed {args.seed}, second pass): "
              f"{'IDENTICAL transaction log' if ok else 'MISMATCH'}")
        if not ok:
            sys.exit("seed reproducibility broken")

    if not report.passed and not args.inject_bug:
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
