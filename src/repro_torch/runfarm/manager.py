"""CampaignManager: sharded, resumable, coverage-guided campaigns.

The run farm turns the harness's per-run determinism into fleet-scale
throughput (FireSim's ``run_farm.py`` /
``instance_deploy_manager.py`` idiom).  A campaign is a seed plus a list
of generation-0 ``WorkUnit``s; the manager

* executes units on ``device`` **sequentially in-process** (``workers=0``,
  the oracle lane) or across **spawned worker processes**, each with a
  private task queue and manager-tracked assignment — a SIGKILL'd worker
  is detected
  by process liveness, its in-flight unit re-enqueued to a fresh worker,
  and the campaign continues;
* **persists** every completed unit to a JSONL ``ResultStore`` (single
  writer: the manager); a restarted campaign skips stored units whose
  payload hash still matches and reproduces the identical final digest;
* merges per-unit sparse coverage into one ``CoverageModel`` **in uid
  order at the generation barrier** (never concurrently), and schedules
  the next generation **coverage-guided**: units whose results newly
  covered bins become mutation parents — seeds that find new behaviour
  get mutation priority, seeds that don't are dropped (Grimm-style
  semiformal stimulus search);
* collects worker-side **failure harvests** (shrunk fuzz repros,
  bisected sweep divergences — built on the existing ``shrink()`` /
  ``bisect_divergence`` machinery) into ``<campaign>/bundles/``.

Determinism bar: unit seeds are uid-forked, the merge is uid-ordered,
and generations are barriers — so the merged coverage, every per-unit
digest, and the final campaign digest are byte-identical at ANY worker
count, across kill+respawn, and across interrupt+resume.  Wall-clock
(``seconds``, per-worker utilization, ``ready_seconds``) is measured
honestly and kept out of every digest.  The digests hold across worker
counts on one device; a sweep unit's digest hashes its output bytes, so it
is not compared across devices.  The device is not part of a unit, so the
campaign directory records it once, in its ``device`` file, and a resume
on another kind of device is refused: its stored records would otherwise
stand in for this device's results.
"""
from __future__ import annotations

import collections
import dataclasses
import multiprocessing as mp
import queue as queue_mod
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.coverage import CoverageModel
from repro_torch.runfarm.report import campaign_report, write_report
from repro_torch.runfarm.store import ResultStore
from repro_torch.runfarm.units import WorkUnit, mutate_unit, unit_uid
from repro_torch.runfarm.worker import worker_main


class CampaignInterrupted(RuntimeError):
    """Raised by the ``interrupt_after`` test hook: the campaign stopped
    cleanly mid-flight with its store intact — construct a new manager on
    the same directory to resume."""


@dataclasses.dataclass
class CampaignResult:
    digest: str                       # uid-ordered (uid, digest) sha256
    uids: List[str]                   # this campaign's executed unit set
    records: Dict[str, dict]          # uid -> store record
    coverage: CoverageModel           # merged across all units, uid order
    report: dict                      # campaign_report() payload
    bundles: List[Path]               # harvested failure bundles
    # fleet-wide counter totals (core/counters.py), merged by name in
    # uid order at each generation barrier — like coverage
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return all(self.records[u].get("ok", False) for u in self.uids)


class CampaignManager:
    def __init__(self, campaign_dir, units: List[WorkUnit], *,
                 seed: int = 0, workers: int = 0, generations: int = 1,
                 children_per_parent: int = 2, max_parents: int = 4,
                 mutate: Callable[[WorkUnit, int, str], WorkUnit]
                 = mutate_unit,
                 kill_worker_after: Optional[Dict[int, int]] = None,
                 interrupt_after: Optional[int] = None,
                 extra_sys_path: Optional[List[str]] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        # every unit runs on ``device``, in process or in the workers
        self.device = str(resolve_device(device))
        self.dir = Path(campaign_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.units = list(units)
        self.seed = int(seed)
        self.workers = int(workers)
        self.generations = max(1, int(generations))
        self.children_per_parent = max(1, int(children_per_parent))
        self.max_parents = max(1, int(max_parents))
        self.mutate = mutate
        # test hooks: {initial worker index: SIGKILL before its (n+1)-th
        # unit} / raise CampaignInterrupted after N newly stored units
        self.kill_worker_after = dict(kill_worker_after or {})
        self.interrupt_after = interrupt_after
        self.extra_sys_path = (list(extra_sys_path)
                               if extra_sys_path is not None
                               else self._default_sys_path())
        self._claim_device()
        self.store = ResultStore(self.dir / "results.jsonl")
        self.coverage = CoverageModel()
        # pool state (populated while running with workers > 0)
        self._workers: Dict[int, dict] = {}
        self._result_q = None
        self._ctx = None
        self._spawned = 0
        self._respawned = 0
        self._completed_new = 0
        # worker id -> seconds from its spawn to its "ready" message
        self.ready_seconds: Dict[int, float] = {}

    def _claim_device(self) -> None:
        """Stamp the campaign directory with this run's device kind, or
        refuse a directory stamped with another."""
        path = self.dir / "device"
        mine = torch.device(self.device).type
        if path.exists():
            theirs = path.read_text().strip()
            if theirs != mine:
                raise ValueError(
                    f"campaign dir {self.dir} holds results from device "
                    f"{theirs!r}; this campaign runs on {mine!r} — use a "
                    f"fresh directory")
        else:
            path.write_text(mine + "\n")

    @staticmethod
    def _default_sys_path() -> List[str]:
        # src/repro_torch/runfarm/manager.py -> src/
        return [str(Path(__file__).resolve().parents[2])]

    # ---------------------------------------------------------------- run
    def run(self) -> CampaignResult:
        t0 = time.perf_counter()
        records = self.store.load()
        executed: List[str] = []
        trajectory: List[dict] = []
        worker_stats: Dict[int, dict] = {}
        bundles: List[Path] = []
        skipped = 0
        self.coverage = CoverageModel()
        counter_totals: Dict[str, float] = {}
        gen_units = sorted(self.units, key=lambda u: u.uid)
        gen = 0
        try:
            if self.workers > 0:
                self._pool_start()
            while gen_units:
                skipped += self._run_generation(gen_units, records,
                                                worker_stats)
                # generation barrier: merge coverage + pick parents in
                # uid order — deterministic at any worker count
                parents: List[WorkUnit] = []
                new_bins_total: List[str] = []
                for u in gen_units:
                    rec = records[u.uid]
                    new = self.coverage.merge_counts(rec.get("counts")
                                                     or {})
                    for cname, v in (rec.get("counters") or {}).items():
                        counter_totals[cname] = (counter_totals.get(cname, 0)
                                                 + v)
                    executed.append(u.uid)
                    if new:
                        parents.append(u)
                        new_bins_total.extend(new)
                    if rec.get("harvest") or not rec.get("ok", True):
                        bundles.append(self._write_bundle(u, rec))
                trajectory.append({
                    "generation": gen,
                    "units": len(gen_units),
                    "new_bins": len(new_bins_total),
                    "newly_covered": new_bins_total[:32],
                    "covered": sum(1 for g in self.coverage.counts
                                   for n in
                                   self.coverage.counts[g].values()
                                   if n > 0),
                })
                gen += 1
                if gen >= self.generations or not parents:
                    break                     # budget spent / plateau
                gen_units = [
                    self.mutate(p, j, unit_uid(gen, i * self.
                                               children_per_parent + j))
                    for i, p in enumerate(parents[:self.max_parents])
                    for j in range(self.children_per_parent)]
        finally:
            if self.workers > 0:
                self._pool_stop()
            self.store.close()
        wall = time.perf_counter() - t0
        digest = ResultStore.final_digest(records, executed)
        report = campaign_report(
            seed=self.seed, workers=self.workers, wall_seconds=wall,
            records=records, uids=executed, coverage=self.coverage,
            trajectory=trajectory, worker_stats=worker_stats,
            skipped=skipped, respawned=self._respawned,
            final_digest=digest, counter_totals=counter_totals)
        write_report(self.dir / "report.json", report)
        return CampaignResult(digest=digest, uids=sorted(executed),
                              records=records, coverage=self.coverage,
                              report=report, bundles=bundles,
                              counters=counter_totals)

    # -------------------------------------------------- generation driving
    def _run_generation(self, units: List[WorkUnit],
                        records: Dict[str, dict],
                        worker_stats: Dict[int, dict]) -> int:
        """Execute one generation's units (resume-aware); returns how many
        were skipped because the store already holds a matching record."""
        to_run: List[WorkUnit] = []
        skipped = 0
        for u in units:
            rec = records.get(u.uid)
            if rec is not None and rec.get("payload") == u.payload_hash():
                skipped += 1              # resumed: record replays merge
            else:
                to_run.append(u)
        if not to_run:
            return skipped
        if self.workers == 0:
            for u in to_run:
                from repro_torch.runfarm.builtin import execute_unit
                res = execute_unit(u, self.device)
                res.worker = 0
                self._commit(res.record(u.payload_hash()), records,
                             worker_stats)
        else:
            self._run_pool_generation(to_run, records, worker_stats)
        return skipped

    def _commit(self, rec: dict, records: Dict[str, dict],
                worker_stats: Dict[int, dict]) -> None:
        """Single-writer store append + bookkeeping + interrupt hook."""
        self.store.append(rec)
        records[rec["uid"]] = rec
        ws = worker_stats.setdefault(int(rec.get("worker", 0)),
                                     {"units": 0, "busy_seconds": 0.0})
        ws["units"] += 1
        ws["busy_seconds"] += float(rec.get("seconds", 0.0))
        self._completed_new += 1
        if (self.interrupt_after is not None
                and self._completed_new >= self.interrupt_after):
            raise CampaignInterrupted(
                f"interrupted after {self._completed_new} new units "
                f"(store: {self.store.path})")

    # ------------------------------------------------------- process pool
    def _pool_start(self) -> None:
        self._ctx = mp.get_context("spawn")
        self._result_q = self._ctx.Queue()
        for i in range(self.workers):
            self._spawn_worker(kill_after=self.kill_worker_after.get(i))

    def _spawn_worker(self, kill_after: Optional[int] = None) -> None:
        wid = self._spawned
        self._spawned += 1
        q = self._ctx.Queue()
        proc = self._ctx.Process(
            target=worker_main,
            args=(wid, q, self._result_q, self.extra_sys_path, kill_after,
                  self.device),
            daemon=True)
        self._workers[wid] = {"proc": proc, "q": q, "unit": None,
                              "spawned": time.time()}
        proc.start()

    def _run_pool_generation(self, to_run: List[WorkUnit],
                             records: Dict[str, dict],
                             worker_stats: Dict[int, dict]) -> None:
        pending = {u.uid: u for u in to_run}
        backlog = collections.deque(to_run)
        while pending:
            # assign idle workers (manager-tracked, one unit in flight
            # per worker — the crash-recovery unit of accounting)
            for w in self._workers.values():
                if w["unit"] is None and backlog:
                    u = backlog.popleft()
                    w["unit"] = u
                    w["q"].put(u.to_json())
            try:
                kind, wid, payload = self._result_q.get(timeout=0.2)
            except queue_mod.Empty:
                self._reap_dead_workers(pending, backlog)
                continue
            if kind == "done":
                uid = payload["uid"]
                w = self._workers.get(wid)
                if w is not None and w["unit"] is not None \
                        and w["unit"].uid == uid:
                    w["unit"] = None
                if uid in pending:        # duplicate delivery: ignore
                    del pending[uid]
                    self._commit(payload, records, worker_stats)
            elif kind == "error":
                raise RuntimeError(
                    f"unit {payload['uid']} failed in worker {wid}: "
                    f"{payload['error']}")
            elif kind == "ready" and wid in self._workers:
                self.ready_seconds[wid] = (payload
                                           - self._workers[wid]["spawned"])
            # "bye" only arrives during shutdown

    def _reap_dead_workers(self, pending: Dict[str, WorkUnit],
                           backlog: collections.deque) -> None:
        """Crash recovery: a dead worker's in-flight unit goes back on
        the backlog and a replacement (without any kill hook) spawns."""
        for wid in [w for w, st in self._workers.items()
                    if not st["proc"].is_alive()]:
            st = self._workers.pop(wid)
            st["q"].cancel_join_thread()
            st["q"].close()
            u = st["unit"]
            if u is not None and u.uid in pending:
                backlog.append(u)
            # cap respawns so a worker that dies at STARTUP (broken env,
            # not a mid-unit crash) fails the campaign instead of
            # spawn-storming forever
            if self._respawned >= 2 * self.workers + 4:
                raise RuntimeError(
                    f"worker {wid} died and the respawn budget is spent "
                    f"({self._respawned} respawns) — workers appear "
                    f"unable to start; see campaign dir {self.dir}")
            self._respawned += 1
            self._spawn_worker()

    def _pool_stop(self) -> None:
        for st in self._workers.values():
            try:
                st["q"].put(None)
            except (ValueError, OSError):
                pass
        deadline = time.monotonic() + 10.0
        for st in self._workers.values():
            st["proc"].join(timeout=max(0.1, deadline - time.monotonic()))
            if st["proc"].is_alive():
                st["proc"].terminate()
                st["proc"].join(timeout=2.0)
            st["q"].cancel_join_thread()
            st["q"].close()
        self._workers.clear()
        if self._result_q is not None:
            self._result_q.cancel_join_thread()
            self._result_q.close()
            self._result_q = None

    # ----------------------------------------------------------- bundles
    def _write_bundle(self, unit: WorkUnit, rec: dict) -> Path:
        """Persist one harvested failure: the seed-closed unit spec plus
        its shrunk repro / divergence localization — enough to reproduce
        without the campaign."""
        import json
        bdir = self.dir / "bundles"
        bdir.mkdir(exist_ok=True)
        path = bdir / (unit.uid.replace("/", "_") + ".json")
        path.write_text(json.dumps(
            {"unit": unit.to_json(), "failures": rec.get("failures", []),
             "harvest": rec.get("harvest")}, indent=2, sort_keys=True)
            + "\n")
        return path
