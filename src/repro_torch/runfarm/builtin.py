"""Built-in work-unit executors: fuzz batches, co-verify sweep slices,
golden-trace regeneration, open-loop serving SLO cells.

Every executor is a pure function of its ``WorkUnit`` and the device it
runs on — fresh fuzzer / session / coverage model per call, nothing read
from ambient state — so a unit executes bit-identically in the sequential
oracle (``workers=0``) and in any spawned worker process on the same
device.  Imports are deliberately lazy: a registers-layer fuzz worker
never builds a backend table or a model, so it never creates a CUDA
tensor.  No executor calls ``torch.compile``: every backend table is built
with ``jit=False``, so the ``compiled`` tier of a unit is the oracle
callable, as in the JAX package's farm, and a worker pays for no graph
build.

Failure harvesting happens HERE, worker-side, where the failing state is
live: a failing fuzz scenario is minimized with
``ProtocolFuzzer.shrink`` (checkpointed replay, core/replay.py) and a
divergent sweep group is localized by the scheduler's
``bisect_divergence`` lane; the shrunk repro rides back to the manager in
``UnitResult.harvest`` and lands in the campaign's ``bundles/``.
"""
from __future__ import annotations

import hashlib
import time
from pathlib import Path
from typing import Callable, Dict, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.runfarm.units import UnitResult, WorkUnit

Device = Union[str, torch.device]

# src/repro_torch/runfarm/builtin.py -> repository root
GOLDEN = Path(__file__).resolve().parents[3] / "tests" / "golden"


def execute_unit(unit: WorkUnit, device: Device = "cuda") -> UnitResult:
    """Run one unit under its registered executor on ``device`` (timed)."""
    dev = resolve_device(device)
    try:
        fn = EXECUTORS[unit.kind]
    except KeyError:
        raise KeyError(f"no executor for unit kind {unit.kind!r} "
                       f"(known: {sorted(EXECUTORS)})") from None
    t0 = time.perf_counter()
    res = fn(unit, dev)
    res.seconds = time.perf_counter() - t0
    return res


# ---------------------------------------------------------- fuzz batches
def _mm_table(device: torch.device, bug=None) -> dict:
    """The bridge layer's matmul table on ``device``, without
    ``torch.compile``; with ``bug=(i, j, delta)`` the known
    interpret-backend divergence of core/fuzz.planted_bug_table."""
    import numpy as np

    from repro_torch.core.fuzz import ProtocolFuzzer
    from repro_torch.kernels.systolic_matmul.sweep import matmul_backends
    table = matmul_backends(tile=ProtocolFuzzer.TILE, device=device,
                            jit=False)
    if bug is None:
        return table
    good = table["interpret"]
    i, j, delta = int(bug[0]), int(bug[1]), float(bug[2])

    def buggy(a, b):
        out = np.array(good(a, b))
        out[i, j] += delta
        return out
    return dict(table, interpret=buggy)


def _run_fuzz_batch(unit: WorkUnit, device: torch.device) -> UnitResult:
    from repro_torch.core.coverage import CoverageModel
    from repro_torch.core.fuzz import ProtocolFuzzer
    p = unit.params
    kw = {}
    if p.get("rates"):
        kw["rates"] = dict(p["rates"])
    if p.get("bridge_ops"):
        kw["bridge_ops"] = tuple(p["bridge_ops"])
    if "bridge" in p["layers"]:
        kw["mm_table"] = _mm_table(device, p.get("mm_bug"))
    cov = CoverageModel()
    fz = ProtocolFuzzer(seed=unit.seed, layers=tuple(p["layers"]),
                        coverage=cov, device=device, **kw)
    report = fz.run(int(p["count"]))
    failing = report.failures()
    harvest = None
    if failing and p.get("shrink_failures", True):
        # minimize the FIRST failing scenario (checkpointed-replay shrink
        # for bridge scenarios, linear prefix search otherwise) — the
        # batch is seed-closed, so the bundle alone reproduces it
        r0 = failing[0]
        scn = fz.scenario(r0.index)
        sub, res = fz.shrink(scn)
        harvest = {"scenario": r0.index, "layer": r0.layer,
                   "seed": unit.seed,
                   "full_ops": len(scn.ops), "shrunk_ops": len(sub.ops),
                   "ops": [repr(op) for op in sub.ops],
                   "failures": res.failures[:4]}
    return UnitResult(
        uid=unit.uid, kind=unit.kind, ok=report.passed,
        digest=report.digest, counts=cov.to_counts(),
        scenarios=len(report.results),
        failures=[f"scn{r.index}[{r.layer}]: {r.failures[0]}"
                  for r in failing][:8],
        harvest=harvest)


# ------------------------------------------------------------ sweep cells
def _run_sweep(unit: WorkUnit, device: torch.device) -> UnitResult:
    import numpy as np

    from repro_torch.core import CongestionConfig, CoVerifySession
    from repro_torch.core.coverage import CoverageModel
    from repro_torch.core.fuzz import FaultPlan
    from repro_torch.kernels.systolic_matmul.sweep import (matmul_backends,
                                                           matmul_firmware)
    p = unit.params
    table = matmul_backends(device=device, jit=False)
    interp = table["interpret"]
    if p.get("mm_bug"):
        bi, bj, delta = p["mm_bug"]
        good = interp

        def interp(a, b, _good=good, _i=int(bi), _j=int(bj),
                   _d=float(delta)):
            out = np.array(_good(a, b))
            out[_i, _j] += _d
            return out
    cov = CoverageModel()
    sess = CoVerifySession(
        matmul_firmware,
        congestion=CongestionConfig(seed=int(p.get("congestion_seed", 7))),
        fault_plan=FaultPlan(unit.seed), coverage=cov)
    sess.register_op("mm", oracle=table["oracle"], interpret=interp)
    for cfg in p["configs"]:
        for be in p.get("backends", ("oracle", "interpret")):
            sess.add_cell("mm", be, dict(cfg))
    # in-unit max_workers=1: parallelism is the FARM's axis; the unit
    # itself stays the sequential oracle (bisect_failures localizes any
    # divergent group via the replay machinery)
    rep = sess.run(max_workers=1, bisect_failures=True)
    # the rows carry no values; the output bytes make the digest a witness
    # that a value changed between runs or worker counts on one device
    h = hashlib.sha256()
    for row in rep.to_rows(wall=False):
        h.update(row.encode())
        h.update(b"\n")
    for r in rep.cells:
        for name in sorted(r.outputs):
            h.update(name.encode())
            h.update(np.ascontiguousarray(r.outputs[name]).tobytes())
    summary = rep.summary()
    harvest = None
    if summary["divergences"]:
        harvest = {"seed": unit.seed, "divergences": summary["divergences"],
                   "failures": summary["failures"]}
    # always-on counter totals summed over the unit's cells (each cell
    # already carries its oracle payload)
    counters: Dict[str, float] = {}
    for r in rep.cells:
        for name, v in (r.counters or {}).get("totals", {}).items():
            counters[name] = counters.get(name, 0) + v
    return UnitResult(
        uid=unit.uid, kind=unit.kind, ok=rep.passed, digest=h.hexdigest(),
        counts=cov.to_counts(), scenarios=len(rep.cells),
        failures=summary["failures"][:8], harvest=harvest,
        counters=counters)


# --------------------------------------------------- open-loop serving SLO
def _run_serving_campaign(unit: WorkUnit, device: torch.device
                          ) -> UnitResult:
    """One open-loop serving unit: regenerate the arrival trace from the
    unit's forked seed (serving/arrivals.build_trace — the trace is pure
    JSON + seed), drive it against a fresh continuous-batching engine with
    a paged KV cache, and witness the run with ``SLOReport.digest()`` —
    rows AND token streams, so any latency-model or behavioral drift flips
    the campaign digest.  Admission invariants (exact token budgets, pool
    fully drained) are checked worker-side where the engine is live."""
    from repro_torch.core.coverage import CoverageModel
    from repro_torch.core.replay import target_logs
    from repro_torch.serving import SLOReport, build_trace, run_open_loop

    p = unit.params
    trace = build_trace(p["kind"], unit.seed, **dict(p.get("trace") or {}))
    pool = dict(p.get("pool") or {})
    target = _serving_target(
        devices=int(p.get("devices", 1)),
        max_slots=int(pool.get("max_slots", 2)),
        max_len=int(pool.get("max_len", 32)),
        prompt_pad=int(pool.get("prompt_pad", 8)),
        kv_pages=pool.get("kv_pages"),
        kv_page_size=int(pool.get("kv_page_size", 8)), device=device)
    failures = []
    slo = None
    try:
        run_open_loop(target, trace,
                      max_ticks=int(p.get("max_ticks", 50_000)))
        slo = SLOReport.from_run(trace, target,
                                 label=f"{unit.uid}:{trace.label}")
    except Exception as e:
        failures.append(f"{type(e).__name__}: {e}")
    violations = (list(target.violations)
                  if hasattr(target, "violations")
                  else list(target.mem.log.violations))
    engines = getattr(target, "engines", None) or [target]
    # admission invariants: every admitted request retired with its exact
    # decode budget, and every reserved page came back to the pool
    rejected = {int(v.split()[1]) for v in violations
                if "exceeds KV page pool" in v}
    for a in trace.arrivals:
        req = target.requests.get(a.rid)
        if a.rid in rejected:
            if req is not None:
                failures.append(f"rejected rid {a.rid} holds a slot")
            continue
        if req is None or not req.done:
            failures.append(f"admitted rid {a.rid} never retired")
        elif len(req.out_tokens) != a.max_new_tokens:
            failures.append(
                f"rid {a.rid}: {len(req.out_tokens)} tokens != "
                f"budget {a.max_new_tokens}")
    for i, eng in enumerate(engines):
        kp = eng.kv_pool
        if kp is not None and (kp.n_free != kp.n_pages or kp.pages):
            failures.append(f"engine {i} leaked KV pages: "
                            f"{kp.n_free}/{kp.n_pages} free after drain")
    cov = CoverageModel()
    for log in target_logs(target):
        for tx in log.txs:
            cov.hit_burst(tx.nbytes)
            cov.hit_congestion(tx.stall)
    cov.hit("arrivals", trace.kind)
    pools = [e.kv_pool for e in engines if e.kv_pool is not None]
    deferrals = sum(kp.deferrals for kp in pools)
    if deferrals:
        cov.hit("arrivals", "deferred", deferrals)
    if any(kp.peak_in_use == kp.n_pages for kp in pools):
        cov.hit("arrivals", "pool_full")
    if rejected:
        cov.hit("arrivals", "infeasible_reject", len(rejected))
    if slo is not None:
        digest = slo.digest()
    else:
        digest = hashlib.sha256(
            "\n".join(failures).encode()).hexdigest()
    harvest = None
    if failures:
        harvest = {"seed": unit.seed, "trace": trace.label,
                   "failures": failures[:8], "violations": violations[:8]}
    from repro_torch.core.counters import counter_banks, merged_totals
    return UnitResult(
        uid=unit.uid, kind=unit.kind, ok=not failures, digest=digest,
        counts=cov.to_counts(), scenarios=len(trace.arrivals),
        failures=failures[:8], harvest=harvest,
        counters=merged_totals(counter_banks(target)))


def _serving_params(cfg, device: torch.device):
    """The served model's bf16 weights, drawn from seed 0 on ``device``
    (the generator ``goldens._smoke_model`` uses)."""
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=device).manual_seed(0)
    return init_params(cfg, gen, dtype=torch.bfloat16)


def _serving_target(*, devices: int, max_slots: int, max_len: int,
                    prompt_pad: int, kv_pages, kv_page_size: int,
                    device: torch.device):
    """Fresh continuous-batching serving target on the smoke model —
    model-lazy so non-serving workers never build one."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import ClusterServingEngine, ServingEngine

    cfg = smoke(get_config("llama3.2-1b"))
    params = _serving_params(cfg, device)
    kw = dict(max_slots=max_slots, max_len=max_len, prompt_pad=prompt_pad,
              flags=RunFlags(attn_impl="chunked", q_chunk=16, kv_chunk=16),
              batching="continuous", kv_pages=kv_pages,
              kv_page_size=kv_page_size, device=device)
    if devices > 1:
        return ClusterServingEngine(cfg, params, n_devices=devices, **kw)
    return ServingEngine(cfg, params, **kw)


# ------------------------------------------------------ golden-trace regen
def _run_golden(unit: WorkUnit, device: torch.device) -> UnitResult:
    """Run the golden program directly (``repro_torch.goldens``) and diff
    its rendering against the committed file; the counters are those of
    the program's own target (a recording would only observe it)."""
    from repro_torch import goldens
    from repro_torch.core.counters import counter_banks, merged_totals
    name = unit.params["name"]
    target = goldens.PROGRAMS[name](device)
    lines = goldens.trace_lines(target)
    text = "\n".join(lines) + "\n"
    golden_path = GOLDEN / f"{name}.trace"
    committed = golden_path.read_text() if golden_path.exists() else None
    ok = text == committed
    failures = [] if ok else [
        f"regenerated trace diverges from committed {golden_path.name} "
        f"({len(lines)} live lines vs "
        f"{len(committed.splitlines()) if committed else 0} golden)"]
    return UnitResult(
        uid=unit.uid, kind=unit.kind, ok=ok,
        digest=hashlib.sha256(text.encode()).hexdigest(),
        counts={}, scenarios=1, failures=failures,
        counters=merged_totals(counter_banks(target)))


EXECUTORS: Dict[str, Callable[[WorkUnit, torch.device], UnitResult]] = {
    "fuzz_batch": _run_fuzz_batch,
    "sweep": _run_sweep,
    "golden": _run_golden,
    "serving": _run_serving_campaign,
}
