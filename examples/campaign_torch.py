"""Run-farm campaign walkthrough on the PyTorch port
(src/repro_torch/runfarm/).

Shards a seeded register-protocol fuzz campaign into work units, runs it
through the sequential in-process oracle and then a 2-worker spawned
pool, and shows the determinism bar holding: identical merged coverage
and identical final digest at both worker counts, and again after a
resume from the JSONL result store.  Finishes by harvesting a planted
interpret-backend bug: the failing unit ships a shrunk repro bundle.

Every number below is a digest, count, or modeled quantity (no wall
time), so the transcript is deterministic and the same on any device: it
is the fenced transcript of docs/runfarm.md, line for line.

    PYTHONPATH=src python examples/campaign_torch.py [--device cpu]
"""
import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.runfarm import CampaignManager, fuzz_units


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device every unit runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    kw = dict(device=args.device)
    tmp = Path(tempfile.mkdtemp(prefix="campaign_"))
    try:
        units = fuzz_units(seed=42, n_scenarios=600, batch=150)
        print("run-farm campaign: 600 register-protocol fuzz scenarios")
        print(f"  gen 0: {len(units)} units x 150 scenarios, "
              "coverage-guided mutation after each generation")

        oracle = CampaignManager(tmp / "oracle", units, seed=42,
                                 workers=0, generations=3, **kw).run()
        det = oracle.report["deterministic"]
        print("\nsequential oracle (workers=0):")
        print(f"  units {det['units']}  scenarios {det['scenarios']}  "
              f"final digest {oracle.digest[:16]}")
        for t in det["trajectory"]:
            print(f"  gen {t['generation']}: {t['units']} units, "
                  f"+{t['new_bins']} new bins -> {t['covered']} covered")
        print("  protocol coverage "
              f"{oracle.coverage.percent('protocol'):.1f}%")

        pool = CampaignManager(tmp / "pool", units, seed=42,
                               workers=2, generations=3, **kw).run()
        same_digest = pool.digest == oracle.digest
        same_cov = pool.coverage.counts == oracle.coverage.counts
        print("\n2-worker spawned pool:")
        print(f"  final digest {pool.digest[:16]}  "
              f"({'identical' if same_digest else 'DIVERGED'})")
        print(f"  merged coverage identical: {same_cov}")

        resumed = CampaignManager(tmp / "pool", units, seed=42,
                                  workers=2, generations=3, **kw).run()
        n_skip = resumed.report["timing"]["units_resumed_from_store"]
        print(f"  resume from store: {n_skip} units skipped, digest "
              f"{'identical' if resumed.digest == oracle.digest else 'DIVERGED'}")

        bug = fuzz_units(seed=5, n_scenarios=2, batch=2,
                         layers=("bridge",), bridge_ops=[2, 4],
                         mm_bug=(1, 2, 1.0))
        res = CampaignManager(tmp / "bug", bug, seed=5, **kw).run()
        h = json.loads(res.bundles[0].read_text())["harvest"]
        print("\nplanted interpret-backend bug (c[1,2] += 1.0), "
              "2 bridge scenarios:")
        print(f"  campaign passed: {res.passed}; harvested bundle: "
              f"bundles/{res.bundles[0].name}")
        print(f"  scenario {h['scenario']} shrunk: {h['full_ops']} -> "
              f"{h['shrunk_ops']} launches")
        return 0 if same_digest and same_cov and not res.passed else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
