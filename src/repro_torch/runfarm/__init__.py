"""Run-farm campaign orchestration (docs/runfarm.md), on the port.

Shards fuzz batches, co-verify sweep slices, and golden-trace
regeneration across worker processes with a resumable JSONL result
store, uid-ordered coverage merging, coverage-guided generation
scheduling, and worker-side failure harvesting — same campaign seed ⇒
same merged digest at any worker count.  Units run on the ``device`` the
manager is given (default ``"cuda"``), in process or in spawned workers.
"""
from repro_torch.runfarm.builtin import EXECUTORS, execute_unit
from repro_torch.runfarm.manager import (CampaignInterrupted,
                                         CampaignManager, CampaignResult)
from repro_torch.runfarm.report import campaign_report, deterministic_view, \
    write_report
from repro_torch.runfarm.store import ResultStore
from repro_torch.runfarm.units import (UnitResult, WorkUnit, fork_seed,
                                       fuzz_units, golden_units, mutate_unit,
                                       serving_units, sweep_units, unit_uid)

__all__ = [
    "CampaignInterrupted", "CampaignManager", "CampaignResult",
    "EXECUTORS", "ResultStore", "UnitResult", "WorkUnit",
    "campaign_report", "deterministic_view", "execute_unit", "fork_seed",
    "fuzz_units", "golden_units", "mutate_unit", "serving_units",
    "sweep_units", "unit_uid", "write_report",
]
