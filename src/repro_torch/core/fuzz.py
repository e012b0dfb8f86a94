"""Seeded fault-injection + randomized-stimulus co-verification (the
paper's randomized memory bridges and register-level protocol testing,
§IV, turned into a reusable harness).

Three layers of hostile stimulus, one reproducibility contract:

* **bridge** — device-side DMA bursts are delayed, reordered, and split;
  ``dev_read`` data suffers transient bit flips that an audited ECC-style
  retry must heal; the congestion config is perturbed.  All of it happens
  while the same firmware runs against the oracle / interpret / compiled
  backends, and the differential checker asserts the final DDR state stays
  equivalent — faults may only perturb *timing*, never *function*.
* **registers** — randomized read/write sequences against a CSR map with
  RO/W1C/doorbell semantics, illegal-access storms, doorbell-while-busy
  races, and W1C edge patterns, differentially checked against a golden
  shadow model that predicts every read value and every violation message.
* **serving** — randomized submit streams through the serving engine's CSR
  protocol: shuffled order, duplicate request ids, zero/max
  ``max_new_tokens``, prompt lengths straddling the pad buckets.

Everything derives from one seed through a ``FaultPlan``: the same seed
produces the identical fault trace, the identical transaction log, and the
identical report digest — so any failing scenario is a one-line repro, and
``ProtocolFuzzer.shrink`` minimizes it to its shortest failing op prefix.

The backends of the bridge layer and the serving engine run on ``device``
(default ``"cuda"``): ``interpret`` is the hand-written matmul kernel there
(its plain version when ``device`` is the CPU).  The plan, the stimulus,
the shadow model and every digest are host Python and numpy, identical on
either device.

Every injected fault is audited in ``TransactionLog.faults`` (never
silently absorbed); every provoked protocol violation must show up in
``TransactionLog.violations`` exactly as predicted.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bridge import FireBridge
from repro_torch.core.congestion import CongestionConfig
from repro_torch.core.coverage import CoverageModel
from repro_torch.core.equivalence import compare_outputs
from repro_torch.core.registers import RO, W1C, RegisterFile
from repro_torch.core.transactions import (BurstBatch, Transaction,
                                           TransactionLog)
from repro_torch.kernels.systolic_matmul import ops as mm_ops
from repro_torch.kernels.systolic_matmul.sweep import matmul_backends

# P(inject) per opportunity, by fault kind (bridge layer).
DEFAULT_RATES: Dict[str, float] = {
    "dma_delay": 0.20,          # bursts issued late (min-issue time bumped)
    "dma_reorder": 0.20,        # burst batch permuted
    "dma_split": 0.20,          # one burst split into two half-bursts
    "bitflip_read": 0.15,       # transient flip on dev_read, retry heals
    "congestion_perturb": 0.50,  # link parameters jittered (timing only)
}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault, as recorded in the plan's reproducible trace."""
    scenario: int               # owning scenario index (-1 = standalone)
    layer: str                  # "bridge" | "registers" | "serving"
    kind: str                   # taxonomy key (DEFAULT_RATES / stimulus kind)
    detail: str

    def key(self) -> Tuple:
        return (self.scenario, self.layer, self.kind, self.detail)


class FaultPlan:
    """Seeded, forkable fault-injection plan (the harness's one RNG root).

    A plan owns a ``numpy`` Generator and a fault-rate table.  The bridge
    calls its hooks (``perturb_congestion``, ``perturb_bursts``,
    ``flip_read``) at each injection opportunity; every injected fault is
    appended to ``events`` *and* audited in the bridge's
    ``TransactionLog.faults`` — the trace and the log reproduce exactly
    under the same seed and call sequence.

    ``fork(label)`` derives a child plan whose seed depends only on
    ``(seed, label)`` — NOT on parent RNG state — so concurrent sweep
    cells and per-backend runs stay deterministic regardless of execution
    order.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 scenario: int = -1) -> None:
        self.seed = int(seed)
        self.scenario = scenario
        self.rates = dict(DEFAULT_RATES)
        if rates:
            self.rates.update(rates)
        self.rng = np.random.default_rng(np.random.SeedSequence(self.seed))
        self.events: List[FaultEvent] = []

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> dict:
        """RNG stream position + injected-event trace for a replay
        checkpoint (core/replay.py): a restored plan injects the identical
        remaining fault stream."""
        return {"rng": copy.deepcopy(self.rng.bit_generator.state),
                "events": list(self.events)}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = copy.deepcopy(state["rng"])
        self.events[:] = list(state["events"])

    def fork(self, label: str, scenario: Optional[int] = None) -> "FaultPlan":
        child = int.from_bytes(
            hashlib.sha256(f"{self.seed}/{label}".encode()).digest()[:8],
            "little")
        return FaultPlan(child, rates=self.rates,
                         scenario=self.scenario if scenario is None
                         else scenario)

    def _inject(self, layer: str, kind: str, detail: str,
                log: Optional[TransactionLog]) -> FaultEvent:
        ev = FaultEvent(self.scenario, layer, kind, detail)
        self.events.append(ev)
        if log is not None:
            log.fault(f"[{kind}] {detail}")
        return ev

    # ------------------------------------------------------- bridge hooks
    def perturb_congestion(self, cfg: CongestionConfig,
                           log: Optional[TransactionLog]
                           ) -> CongestionConfig:
        """Maybe jitter the link parameters (timing-only fault)."""
        if self.rng.random() >= self.rates.get("congestion_perturb", 0.0):
            return cfg
        new = cfg.perturbed(self.rng)
        self._inject(
            "bridge", "congestion_perturb",
            f"link {cfg.link_bytes_per_cycle:.0f}->"
            f"{new.link_bytes_per_cycle:.0f} B/cyc, "
            f"dos {cfg.dos_prob:.2f}->{new.dos_prob:.2f}, "
            f"burst {cfg.max_burst_bytes}->{new.max_burst_bytes}", log)
        return new

    def perturb_bursts(self, txs: List[Transaction],
                       log: Optional[TransactionLog]) -> List[Transaction]:
        """Maybe delay / reorder / split one device burst batch."""
        out = list(txs)
        if not out:
            return out
        r = self.rng
        tag = out[0].tag or out[0].engine
        if len(out) > 1 and r.random() < self.rates["dma_reorder"]:
            perm = r.permutation(len(out))
            out = [out[int(i)] for i in perm]
            self._inject("bridge", "dma_reorder",
                         f"{tag}: permuted {len(out)} bursts", log)
        if r.random() < self.rates["dma_split"]:
            i = int(r.integers(len(out)))
            tx = out[i]
            if tx.nbytes > 1:
                half = tx.nbytes // 2
                out[i:i + 1] = [
                    Transaction(tx.time, tx.engine, tx.kind, tx.addr, half,
                                tag=tx.tag),
                    Transaction(tx.time, tx.engine, tx.kind, tx.addr + half,
                                tx.nbytes - half, tag=tx.tag)]
                self._inject("bridge", "dma_split",
                             f"{tag}: burst @{tx.addr:#x} {tx.nbytes}B -> "
                             f"{half}+{tx.nbytes - half}", log)
        if r.random() < self.rates["dma_delay"]:
            delay = float(r.integers(1, 400))
            for tx in out:
                tx.time += delay
                tx.fault_delay += delay     # stall-attribution bookkeeping
            self._inject("bridge", "dma_delay",
                         f"{tag}: +{delay:.0f} cycles min-issue", log)
        return out

    def perturb_batch(self, batch: "BurstBatch",
                      log: Optional[TransactionLog]) -> "BurstBatch":
        """``perturb_bursts`` over a ``BurstBatch`` — the batched hot
        path's injection hook.  Draw-for-draw identical RNG consumption
        and byte-identical audit strings, so a batch-built stream
        reproduces the scalar fault trace exactly (the faulty_fuzz golden
        trace is the witness)."""
        n = len(batch)
        if not n:
            return batch
        r = self.rng
        tag = batch.tag[0] or batch.engine[0]
        if n > 1 and r.random() < self.rates["dma_reorder"]:
            batch.permute(r.permutation(n))
            self._inject("bridge", "dma_reorder",
                         f"{tag}: permuted {n} bursts", log)
        if r.random() < self.rates["dma_split"]:
            i = int(r.integers(len(batch)))
            nb = int(batch.rec["nbytes"][i])
            if nb > 1:
                half = nb // 2
                addr = int(batch.rec["addr"][i])
                batch.split_row(i)
                self._inject("bridge", "dma_split",
                             f"{tag}: burst @{addr:#x} {nb}B -> "
                             f"{half}+{nb - half}", log)
        if r.random() < self.rates["dma_delay"]:
            delay = float(r.integers(1, 400))
            batch.delay(delay)
            self._inject("bridge", "dma_delay",
                         f"{tag}: +{delay:.0f} cycles min-issue", log)
        return batch

    def flip_read(self, data: np.ndarray, tag: str,
                  log: Optional[TransactionLog]) -> bool:
        """Maybe flip one bit of a dev_read payload in place.  Returns True
        when injected; the bridge must then retry (and the retry heals)."""
        if data.nbytes == 0 or self.rng.random() >= self.rates["bitflip_read"]:
            return False
        flat = data.reshape(-1).view(np.uint8)
        byte = int(self.rng.integers(flat.size))
        bit = int(self.rng.integers(8))
        flat[byte] ^= np.uint8(1 << bit)
        self._inject("bridge", "bitflip_read",
                     f"{tag}: byte {byte} bit {bit} flipped (retry healed)",
                     log)
        return True


# --------------------------------------------------------------- scenarios
@dataclasses.dataclass
class Scenario:
    """One randomized fault scenario: a layer plus a pre-generated op list.

    Ops are materialized at generation time (from the scenario's forked
    RNG) so a failing scenario can be re-executed on any *prefix* of its
    ops — the shrinking contract."""
    index: int
    layer: str
    ops: List[Tuple]

    @property
    def label(self) -> str:
        return f"scn{self.index}"


@dataclasses.dataclass
class ScenarioResult:
    index: int
    layer: str
    ok: bool
    failures: List[str]
    faults: List[FaultEvent]
    violations: List[str]
    digest: str                 # sha256 over ops + tx streams + audits
    n_txs: int


@dataclasses.dataclass
class FuzzReport:
    """Outcome of one fuzz run; ``digest`` is the seeded-reproducibility
    witness (same seed => identical digest, fault trace, and logs).
    ``coverage`` accumulates functional-coverage bins across the run
    (core/coverage.py) — the acceptance gate is 100% of the protocol
    bins."""
    seed: int
    results: List[ScenarioResult]
    coverage: Optional[CoverageModel] = None

    @property
    def passed(self) -> bool:
        return all(r.ok for r in self.results)

    def failures(self) -> List[ScenarioResult]:
        return [r for r in self.results if not r.ok]

    def fault_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.results:
            for ev in r.faults:
                out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    @property
    def digest(self) -> str:
        h = hashlib.sha256()
        for r in self.results:
            h.update(r.digest.encode())
        return h.hexdigest()

    def summary(self) -> dict:
        layers: Dict[str, int] = {}
        for r in self.results:
            layers[r.layer] = layers.get(r.layer, 0) + 1
        return {
            "seed": self.seed,
            "scenarios": len(self.results),
            "by_layer": layers,
            "faults": self.fault_counts(),
            "violations_audited": sum(len(r.violations)
                                      for r in self.results),
            "transactions": sum(r.n_txs for r in self.results),
            "passed": self.passed,
            "failures": [f"scn{r.index}[{r.layer}]: {r.failures[0]}"
                         for r in self.failures()][:8],
            "digest": self.digest[:16],
            "coverage": (self.coverage.summary()
                         if self.coverage is not None else None),
        }


def _digest(*parts: Any) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
    return h.hexdigest()


def _tx_tuples(log: TransactionLog) -> List[Tuple]:
    return [(round(t.time, 6), t.engine, t.kind, t.addr, t.nbytes,
             round(t.stall, 6), round(t.complete, 6)) for t in log.txs]


# ------------------------------------------------ register-layer golden model
_JOB_TICKS = 6          # doorbell job duration, in CSR access ticks

_CTRL, _STATUS, _INT, _DOORBELL, _DATA = 0x00, 0x04, 0x08, 0x0C, 0x10
_UNMAPPED = (0x40, 0x44, 0x80, 0x100)


class _FuzzDevice:
    """Synthetic accelerator control plane for register-protocol fuzzing:
    RW CTRL/DATA, RO STATUS (bit0 = busy, refreshed on read), W1C INT
    (bit0 set on job completion), and a DOORBELL that starts a
    ``_JOB_TICKS``-tick job — ringing it mid-job is a protocol violation
    (the doorbell-while-busy race)."""

    def __init__(self, log: TransactionLog) -> None:
        self.csr = RegisterFile("fuzz.csr", log)
        self.csr.define("CTRL", _CTRL)
        self.csr.define("STATUS", _STATUS, access=RO, on_read=self.tick)
        self.csr.define("INT", _INT, access=W1C)
        self.csr.define("DOORBELL", _DOORBELL, on_write=self.ring)
        self.csr.define("DATA", _DATA)
        self.busy_until = -1.0

    def tick(self) -> None:
        if self.csr.hw_get("STATUS") & 1 and self.csr.time >= self.busy_until:
            self.csr.hw_set("STATUS", 0)
            self.csr.hw_set("INT", self.csr.hw_get("INT") | 1)

    def ring(self, _data: int) -> None:
        self.tick()
        if self.csr.hw_get("STATUS") & 1:
            self.csr.log.violation("DOORBELL while busy (job in flight)")
            return
        self.busy_until = self.csr.time + _JOB_TICKS
        self.csr.hw_set("STATUS", 1)


class _ShadowDevice:
    """Golden model of ``_FuzzDevice`` + its RegisterFile protocol: predicts
    every read value, every poll count, and every violation message.  Any
    disagreement with the real device is a fuzz failure."""

    def __init__(self) -> None:
        self.time = 0.0
        self.val = {_CTRL: 0, _STATUS: 0, _INT: 0, _DOORBELL: 0, _DATA: 0}
        self.busy_until = -1.0
        self.violations: List[str] = []

    def tick(self) -> None:
        if self.val[_STATUS] & 1 and self.time >= self.busy_until:
            self.val[_STATUS] = 0
            self.val[_INT] |= 1

    def read(self, addr: int) -> int:
        self.time += 1
        if addr not in self.val:
            self.violations.append(f"read from unmapped address {addr:#x}")
            return 0xDEADBEEF
        if addr == _STATUS:
            self.tick()
        return self.val[addr]

    def write(self, addr: int, data: int) -> None:
        self.time += 1
        data &= 0xFFFFFFFF
        if addr not in self.val:
            self.violations.append(f"write to unmapped address {addr:#x}")
            return
        if addr == _STATUS:
            self.violations.append(
                f"write to read-only register STATUS @ {addr:#x}")
            return
        if addr == _INT:
            self.val[_INT] &= ~data & 0xFFFFFFFF
            return
        self.val[addr] = data
        if addr == _DOORBELL:
            self.tick()
            if self.val[_STATUS] & 1:
                self.violations.append("DOORBELL while busy (job in flight)")
            else:
                self.busy_until = self.time + _JOB_TICKS
                self.val[_STATUS] = 1

    def poll(self, addr: int, name: str, mask: int, value: int,
             max_reads: int) -> int:
        for n in range(1, max_reads + 1):
            if (self.read(addr) & mask) == value:
                return n
        self.violations.append(f"poll timeout on {name} mask={mask:#x}")
        return -1


# ------------------------------------------------------------- the fuzzer
class ProtocolFuzzer:
    """Randomized fault-injection co-verification harness.

    Usage::

        fz = ProtocolFuzzer(seed=0)
        report = fz.run(200)
        assert report.passed
        report2 = fz.run(200)          # same seed, fresh pass
        assert report2.digest == report.digest

    Scenarios round-robin over the enabled layers; each scenario's ops and
    faults derive from ``fork(seed, scenario-label)`` so runs reproduce
    bit-for-bit.  ``shrink`` minimizes a failing scenario to its shortest
    failing op prefix.
    """

    LAYERS = ("bridge", "registers", "serving", "arrivals")
    SIZES = (32, 48, 64)        # matmul sizes for bridge scenarios
    TILE = 16

    def __init__(self, seed: int = 0,
                 layers: Sequence[str] = ("bridge", "registers"),
                 rates: Optional[Dict[str, float]] = None,
                 backends: Tuple[str, ...] = ("oracle", "interpret",
                                              "compiled"),
                 congestion: Optional[CongestionConfig] = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 mm_table: Optional[dict] = None,
                 coverage: Optional[CoverageModel] = None,
                 tol: float = 1e-3,
                 bridge_ops: Tuple[int, int] = (1, 4),
                 device: Union[str, torch.device] = "cuda") -> None:
        unknown = set(layers) - set(self.LAYERS)
        if unknown:
            raise ValueError(f"unknown fuzz layers: {sorted(unknown)}")
        self.device = resolve_device(device)
        self.seed = int(seed)
        # [lo, hi) launch count per bridge scenario — the debug-iteration
        # benchmark raises it to make long shrinkable scenarios
        self.bridge_ops = (int(bridge_ops[0]), int(bridge_ops[1]))
        self.layers = tuple(layers)
        self.plan = FaultPlan(seed, rates=rates)
        # functional-coverage accumulator (core/coverage.py): every
        # scenario feeds protocol/burst/congestion/fault bins into it
        self.coverage = coverage if coverage is not None else CoverageModel()
        self.backends = tuple(backends)
        self.congestion = congestion if congestion is not None else \
            CongestionConfig(dos_prob=0.05, seed=seed)
        self.tol = tol
        # mm_table overrides the bridge-layer backend table — the hook the
        # tests and the --shrink demo use to plant a known-buggy backend
        self._table: Optional[dict] = mm_table
        self._engine: Any = None
        self._engine_factory = engine_factory
        # the last shrink's replay-lane sessions, backend -> (ops_applied,
        # replays); empty after a shrink that took the linear lane only
        self.shrink_counts: Dict[str, Tuple[int, int]] = {}

    # ------------------------------------------------------- lazy backends
    def _matmul_table(self) -> dict:
        if self._table is None:
            self._table = matmul_backends(tile=self.TILE,
                                          device=self.device)
        return self._table

    def _serving_engine(self) -> Any:
        if self._engine is None:
            self._engine = (self._engine_factory() if self._engine_factory
                            else _default_engine(device=self.device))
        return self._engine

    # --------------------------------------------------------- generation
    def scenario(self, i: int) -> Scenario:
        layer = self.layers[i % len(self.layers)]
        rng = self.plan.fork(f"gen/{i}").rng
        gen = {"bridge": self._gen_bridge, "registers": self._gen_registers,
               "serving": self._gen_serving,
               "arrivals": self._gen_arrivals}[layer]
        return Scenario(i, layer, gen(rng))

    def _gen_bridge(self, rng: np.random.Generator) -> List[Tuple]:
        return [("launch", int(rng.choice(self.SIZES)))
                for _ in range(int(rng.integers(*self.bridge_ops)))]

    def _gen_registers(self, rng: np.random.Generator) -> List[Tuple]:
        ops: List[Tuple] = []
        kinds = ["w_ctrl", "w_data", "w_ro", "w_unmapped", "r_mapped",
                 "r_unmapped", "w1c", "doorbell", "poll_idle", "poll_never"]
        weights = np.array([2, 2, 1, 1, 3, 1, 2, 3, 2, 1], float)
        weights /= weights.sum()
        for _ in range(int(rng.integers(6, 28))):
            k = str(rng.choice(kinds, p=weights))
            if k in ("w_ctrl", "w_data", "doorbell"):
                ops.append((k, int(rng.integers(0, 2 ** 32))))
            elif k == "w_ro":
                ops.append((k, int(rng.integers(0, 2 ** 32))))
            elif k == "w_unmapped":
                ops.append((k, int(rng.choice(_UNMAPPED)),
                            int(rng.integers(0, 2 ** 32))))
            elif k == "r_mapped":
                ops.append((k, int(rng.choice(
                    (_CTRL, _STATUS, _INT, _DOORBELL, _DATA)))))
            elif k == "r_unmapped":
                ops.append((k, int(rng.choice(_UNMAPPED))))
            elif k == "w1c":
                ops.append((k, int(rng.integers(0, 4))))
            elif k == "poll_idle":
                # enough reads to outlive a job most of the time; sometimes
                # deliberately too few (forced timeout while busy)
                ops.append((k, int(rng.choice((2, _JOB_TICKS + 4)))))
            else:                                   # poll_never
                ops.append((k, int(rng.integers(2, 5))))
        return ops

    def _kv_budget(self, ln: int) -> int:
        """Max max_new_tokens a prompt of length ln can take: prefill fills
        the padded bucket, each decode appends one KV entry.  Derived from
        the engine's own _pad_len so predictor and implementation cannot
        drift."""
        eng = self._serving_engine()
        return max(1, eng.max_len - eng._pad_len(max(1, ln)) + 1)

    def _gen_serving(self, rng: np.random.Generator) -> List[Tuple]:
        eng = self._serving_engine()
        pad, max_len = eng.prompt_pad, eng.max_len
        ops: List[Tuple] = []
        rid = 0
        kinds = ["ok", "ok", "pad_straddle", "dup_rid", "zero_maxnew",
                 "max_maxnew", "bad_len", "over_budget"]
        for _ in range(int(rng.integers(2, 7))):
            k = str(rng.choice(kinds))
            ln = int(rng.integers(2, max_len + 1))
            budget = self._kv_budget(ln)
            mx = int(rng.integers(1, min(8, budget) + 1))
            if k == "pad_straddle":
                ln = int(np.clip(pad + int(rng.integers(-1, 2)), 1, max_len))
                mx = int(rng.integers(1, min(8, self._kv_budget(ln)) + 1))
            elif k == "zero_maxnew":
                mx = 0
            elif k == "max_maxnew":
                mx = budget                 # the full remaining KV budget
            elif k == "bad_len":
                ln = int(rng.choice((0, max_len + 5)))
            elif k == "over_budget":
                mx = budget + int(rng.integers(1, 5))
            if k == "dup_rid" and rid > 0:
                use = int(rng.integers(0, rid))
            else:
                k = "ok" if k == "dup_rid" else k
                use = rid
                rid += 1
            prompt = tuple(int(x) for x in
                           rng.integers(0, eng.cfg.vocab_size,
                                        max(1, min(ln, max_len))))
            ops.append((k, use, ln, mx, prompt))
        return ops

    def _gen_arrivals(self, rng: np.random.Generator) -> List[Tuple]:
        """Hostile open-loop arrival stream + a randomized KV page-pool
        geometry.  Op 0 is the pool config; each following op is one
        arrival ``(kind, rid, time, prompt, max_new)``.  Kinds: "ok"
        (feasible, Poisson-ish gap), "burst" (feasible, zero gap — lands
        simultaneously with its predecessor), "infeasible" (worst-case
        footprint exceeds the WHOLE pool — must be rejected at the
        doorbell, never deferred forever).  The op list shrinks by prefix
        like every other layer (the pool config op always survives)."""
        eng = self._serving_engine()
        max_len, pad = eng.max_len, eng.prompt_pad
        page_size = int(rng.choice((4, 8)))
        n_pages = int(rng.integers(2, 7))
        pool_entries = n_pages * page_size
        cap = min(pool_entries, max_len)
        ln_cap = max(1, (cap // pad) * pad)     # pad_len(ln_cap) <= cap
        ops: List[Tuple] = [("pool", n_pages, page_size)]
        kinds = ["ok", "ok", "ok", "burst", "infeasible"]
        t, rid = 0.0, 0
        for _ in range(int(rng.integers(2, 9))):
            k = str(rng.choice(kinds))
            t = round(t + (0.0 if k == "burst"
                           else float(rng.exponential(150.0))), 6)
            ln = int(rng.integers(1, ln_cap + 1))
            pl = eng._pad_len(ln)
            if k == "infeasible":
                # footprint pl + mx - 1 in (pool_entries, max_len]: pool-
                # infeasible but inside the engine's KV capacity, so the
                # rejection exercised is the PAGE-POOL one
                lo, hi = pool_entries - pl + 2, max_len - pl + 1
                if pool_entries >= max_len or lo < 1 or lo > hi:
                    k = "ok"
                else:
                    mx = int(rng.integers(lo, hi + 1))
            if k != "infeasible":
                budget = cap - pl + 1
                mx = int(rng.integers(1, min(6, budget) + 1))
            prompt = tuple(int(x) for x in
                           rng.integers(1, eng.cfg.vocab_size, ln))
            ops.append((k, rid, t, prompt, mx))
            rid += 1
        return ops

    # ---------------------------------------------------------- execution
    def run_scenario(self, scn: Scenario) -> ScenarioResult:
        run = {"bridge": self._run_bridge, "registers": self._run_registers,
               "serving": self._run_serving,
               "arrivals": self._run_arrivals}[scn.layer]
        return run(scn)

    def _cover_log(self, log: TransactionLog) -> None:
        """Feed one run's transaction stream into the burst-size and
        congestion coverage bins."""
        for tx in log.txs:
            self.coverage.hit_burst(tx.nbytes)
            self.coverage.hit_congestion(tx.stall)

    def _run_bridge(self, scn: Scenario) -> ScenarioResult:
        table = self._matmul_table()
        outs: Dict[str, Dict[str, np.ndarray]] = {}
        faults: List[FaultEvent] = []
        failures: List[str] = []
        streams: List[Tuple] = []
        n_txs = 0
        violations: List[str] = []
        for backend in self.backends:
            plan = self.plan.fork(f"{scn.label}/{backend}",
                                  scenario=scn.index)
            fb = FireBridge(congestion=self.congestion, fault_plan=plan)
            fb.register_op("mm", **table)
            for j, (_, size) in enumerate(scn.ops):
                rng = np.random.default_rng(size * 1009 + j)
                a = rng.normal(size=(size, size)).astype(np.float32)
                b = rng.normal(size=(size, size)).astype(np.float32)
                fb.mem.alloc(f"a{j}", a.shape, np.float32)
                fb.mem.alloc(f"b{j}", b.shape, np.float32)
                fb.mem.alloc(f"c{j}", (size, size), np.float32)
                fb.mem.host_write(f"a{j}", a)
                fb.mem.host_write(f"b{j}", b)
                fb.launch("mm", backend, [f"a{j}", f"b{j}"], [f"c{j}"],
                          engine="mm",
                          burst_list=lambda s=size: mm_ops.transactions(
                              s, s, s, bm=self.TILE, bn=self.TILE,
                              bk=self.TILE, dtype_bytes=4))
            outs[backend] = {n: b.array.copy()
                             for n, b in fb.mem.buffers.items()}
            self._cover_log(fb.log)
            for ev in plan.events:
                self.coverage.hit("fault_kind", ev.kind)
            if len(fb.log.faults) != len(plan.events):
                failures.append(
                    f"audit mismatch on {backend}: {len(plan.events)} "
                    f"injected vs {len(fb.log.faults)} audited")
            faults.extend(plan.events)
            violations.extend(f"[{backend}] {v}" for v in fb.log.violations)
            streams.append((backend, _tx_tuples(fb.log),
                            list(fb.log.faults)))
            n_txs += len(fb.log.txs)
        if violations:
            failures.append(f"unexpected protocol violations: {violations}")
        eq = compare_outputs(outs, tol=self.tol)
        if not eq.passed:
            failures.append(f"backend divergence under faults: {eq}")
        return ScenarioResult(
            scn.index, "bridge", not failures, failures, faults, violations,
            _digest(scn.ops, streams, [e.key() for e in faults]), n_txs)

    def _run_registers(self, scn: Scenario) -> ScenarioResult:
        log = TransactionLog()
        dev = _FuzzDevice(log)
        shadow = _ShadowDevice()
        plan = self.plan.fork(f"{scn.label}/regs", scenario=scn.index)
        failures: List[str] = []
        faults: List[FaultEvent] = []

        def expect(kind: str, detail: str) -> None:
            faults.append(plan._inject("registers", kind, detail, log))

        for op in scn.ops:
            k = op[0]
            if k in ("w_ctrl", "w_data"):
                addr = _CTRL if k == "w_ctrl" else _DATA
                dev.csr.fb_write_32(addr, op[1])
                shadow.write(addr, op[1])
            elif k == "w_ro":
                before = len(shadow.violations)
                dev.csr.fb_write_32(_STATUS, op[1])
                shadow.write(_STATUS, op[1])
                if len(shadow.violations) > before:
                    expect("ro_write", f"STATUS <- {op[1]:#x}")
            elif k == "w_unmapped":
                dev.csr.fb_write_32(op[1], op[2])
                shadow.write(op[1], op[2])
                expect("illegal_write", f"{op[1]:#x} <- {op[2]:#x}")
            elif k == "r_mapped":
                got = dev.csr.fb_read_32(op[1])
                want = shadow.read(op[1])
                if got != want:
                    failures.append(
                        f"read {op[1]:#x}: device {got:#x} != shadow "
                        f"{want:#x}")
            elif k == "r_unmapped":
                got = dev.csr.fb_read_32(op[1])
                want = shadow.read(op[1])
                expect("illegal_read", f"{op[1]:#x}")
                if got != want:
                    failures.append(
                        f"unmapped read {op[1]:#x}: device {got:#x} != "
                        f"shadow {want:#x}")
            elif k == "w1c":
                dev.csr.fb_write_32(_INT, op[1])
                shadow.write(_INT, op[1])
                self.coverage.hit("protocol", "w1c_clear")
            elif k == "doorbell":
                before = len(shadow.violations)
                dev.csr.fb_write_32(_DOORBELL, op[1])
                shadow.write(_DOORBELL, op[1])
                if len(shadow.violations) > before:
                    expect("doorbell_busy", "rang DOORBELL mid-job")
                else:
                    self.coverage.hit("protocol", "doorbell_ok")
            elif k in ("poll_idle", "poll_never"):
                mask, value = (1, 0) if k == "poll_idle" else (2, 2)
                before = len(shadow.violations)
                got = dev.csr.poll("STATUS", mask, value, max_reads=op[1])
                want = shadow.poll(_STATUS, "STATUS", mask, value, op[1])
                if len(shadow.violations) > before:
                    expect("poll_timeout",
                           f"mask={mask:#x} after {op[1]} reads")
                else:
                    self.coverage.hit("protocol", "poll_ok")
                if got != want:
                    failures.append(
                        f"poll({k}): device returned {got}, shadow {want}")
        # violation-path protocol bins come from the recorded expectations
        for ev in faults:
            self.coverage.hit("protocol", ev.kind)
        self._cover_log(log)
        if list(log.violations) != shadow.violations:
            failures.append(
                f"violation audit mismatch: device {log.violations} != "
                f"shadow-predicted {shadow.violations}")
        return ScenarioResult(
            scn.index, "registers", not failures, failures, faults,
            list(log.violations),
            _digest(scn.ops, _tx_tuples(log), list(log.violations),
                    [e.key() for e in faults]), len(log.txs))

    def _run_serving(self, scn: Scenario) -> ScenarioResult:
        eng = self._serving_engine()
        plan = self.plan.fork(f"{scn.label}/serve", scenario=scn.index)
        # explicit storm/unpaged overrides: the shared engine may have run
        # an arrivals scenario (continuous + paged) just before
        eng.reset(fault_plan=plan, batching="storm", kv_pages=None)
        failures: List[str] = []
        expected_viol: List[str] = []
        accepted: Dict[int, int] = {}       # rid -> max_new_tokens

        # stimulus events go to plan.events (the single fault trace, which
        # bridge hooks also append to in op order); the result's faults
        # list is built from it once, after the run
        def expect(kind: str, detail: str, msg: str) -> None:
            plan._inject("serving", kind, detail, None)
            expected_viol.append(msg)

        max_len = eng.max_len
        for kind, rid, ln, mx, prompt in scn.ops:
            eng.mem.buffers["prompt_in"].array[:len(prompt)] = prompt
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_ID"), rid)
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_LEN"), ln)
            eng.csr.fb_write_32(eng.csr.addr_of("SUBMIT_MAXNEW"), mx)
            eng.csr.fb_write_32(eng.csr.addr_of("DOORBELL"), 1)
            pl = eng._pad_len(max(1, ln))
            if ln <= 0 or ln > eng.max_len:
                expect("bad_len", f"rid {rid} len {ln}",
                       f"SUBMIT_LEN out of range: {ln}")
            elif mx <= 0:
                expect("zero_maxnew", f"rid {rid}",
                       f"SUBMIT_MAXNEW must be positive: {mx} "
                       f"(request {rid})")
            elif rid in accepted:
                # no scheduler ticks happen between submissions, so an
                # accepted rid is still in flight here
                expect("dup_rid", f"rid {rid}",
                       f"duplicate SUBMIT_ID {rid}: request still in "
                       f"flight")
            elif pl + mx - 1 > max_len:
                expect("over_budget", f"rid {rid} pl {pl} mx {mx}",
                       f"request {rid} exceeds KV capacity: padded prompt "
                       f"{pl} + {mx} new tokens > max_len {max_len}")
            else:
                accepted[rid] = mx
                if kind == "max_maxnew":
                    plan._inject("serving", "max_maxnew",
                                 f"rid {rid} mx={mx}", None)
                elif kind == "pad_straddle":
                    plan._inject("serving", "pad_straddle",
                                 f"rid {rid} len {ln}", None)
                else:
                    self.coverage.hit("serving", "ok")
        eng.run_until_done()
        for ev in plan.events:
            if ev.layer == "serving":
                self.coverage.hit("serving", ev.kind)
            elif ev.layer == "bridge":
                self.coverage.hit("fault_kind", ev.kind)
        self._cover_log(eng.mem.log)
        faults = list(plan.events)
        n_bridge = sum(1 for e in faults if e.layer == "bridge")
        if len(eng.mem.log.faults) != n_bridge:
            failures.append(
                f"audit mismatch: {n_bridge} bridge faults injected vs "
                f"{len(eng.mem.log.faults)} audited")
        if list(eng.csr.log.violations) != expected_viol:
            failures.append(
                f"violation audit mismatch: engine {eng.csr.log.violations} "
                f"!= predicted {expected_viol}")
        if eng.completed != len(accepted):
            failures.append(f"completed {eng.completed} != accepted "
                            f"{len(accepted)}")
        if eng.csr.hw_get("COMPLETED") != len(accepted) & 0xFFFFFFFF:
            failures.append("COMPLETED CSR out of sync")
        for rid, mx in accepted.items():
            req = eng.requests.get(rid)
            if req is None or not req.done:
                failures.append(f"accepted rid {rid} never completed")
                continue
            if len(req.out_tokens) != mx:
                failures.append(
                    f"rid {rid}: {len(req.out_tokens)} tokens emitted, "
                    f"max_new_tokens={mx}")
        for rid in set(r for _, r, *_ in scn.ops) - set(accepted):
            if rid in eng.requests:
                failures.append(f"rejected rid {rid} leaked into requests")
        tokens = [(rid, tuple(eng.requests[rid].out_tokens))
                  for rid in sorted(accepted) if rid in eng.requests]
        return ScenarioResult(
            scn.index, "serving", not failures, failures, faults,
            list(eng.csr.log.violations),
            _digest(scn.ops, _tx_tuples(eng.mem.log), tokens,
                    list(eng.csr.log.violations),
                    [e.key() for e in faults]), len(eng.mem.log.txs))

    def _run_arrivals(self, scn: Scenario) -> ScenarioResult:
        """Open-loop admission-control differential: drive the scenario's
        hostile arrival stream through a continuous-batching paged engine
        and check the paging invariants — every feasible request retires
        with exactly its token budget, every pool-infeasible request is
        rejected at the doorbell (logged violation, never a silent drop or
        an admission livelock), and after the drain every page is back in
        the free pool."""
        from repro_torch.serving.arrivals import (replayed_trace,
                                                  run_open_loop)
        eng = self._serving_engine()
        plan = self.plan.fork(f"{scn.label}/arrivals", scenario=scn.index)
        _, n_pages, page_size = scn.ops[0]
        eng.reset(fault_plan=plan, batching="continuous",
                  kv_pages=n_pages, kv_page_size=page_size,
                  kv_leak_every=0)
        failures: List[str] = []
        feasible: Dict[int, int] = {}       # rid -> max_new_tokens
        infeasible: List[int] = []
        entries = []
        for kind, rid, t, prompt, mx in scn.ops[1:]:
            entries.append((rid, t, prompt, mx))
            if kind == "infeasible":
                infeasible.append(rid)
            else:
                feasible[rid] = mx
        trace = replayed_trace(entries)
        try:
            run_open_loop(eng, trace, max_ticks=5_000)
        except RuntimeError as e:           # admission livelock / no drain
            failures.append(f"open-loop run did not drain: {e}")
        pool = eng.kv_pool
        self.coverage.hit("arrivals", "replay")
        if pool.deferrals:
            self.coverage.hit("arrivals", "deferred", pool.deferrals)
        if pool.peak_in_use == pool.n_pages:
            self.coverage.hit("arrivals", "pool_full")
        viols = list(eng.csr.log.violations)
        rejected = [v for v in viols if "exceeds KV page pool" in v]
        if infeasible:
            self.coverage.hit("arrivals", "infeasible_reject",
                              len(rejected))
        if len(rejected) != len(infeasible):
            failures.append(
                f"{len(infeasible)} pool-infeasible requests, "
                f"{len(rejected)} doorbell rejections: {viols}")
        if len(viols) != len(rejected):
            failures.append(f"unexpected protocol violations: {viols}")
        for rid, mx in feasible.items():
            req = eng.requests.get(rid)
            if req is None or not req.done:
                failures.append(f"feasible rid {rid} never completed")
            elif len(req.out_tokens) != mx:
                failures.append(
                    f"rid {rid}: {len(req.out_tokens)} tokens emitted, "
                    f"max_new_tokens={mx}")
            elif not (req.t_submit <= req.t_admit <= req.t_first
                      <= req.t_done):
                failures.append(
                    f"rid {rid}: non-monotone lifecycle stamps "
                    f"{req.t_submit}/{req.t_admit}/{req.t_first}/"
                    f"{req.t_done}")
        for rid in infeasible:
            if rid in eng.requests:
                failures.append(f"infeasible rid {rid} leaked into the "
                                f"request table")
        if pool.n_free != pool.n_pages:
            failures.append(f"page leak after drain: {pool.n_free}/"
                            f"{pool.n_pages} free")
        if pool.pages:
            failures.append(f"requests still hold pages after drain: "
                            f"{sorted(pool.pages)}")
        self._cover_log(eng.mem.log)
        faults = list(plan.events)
        for ev in faults:
            if ev.layer == "bridge":
                self.coverage.hit("fault_kind", ev.kind)
        tokens = [(rid, tuple(eng.requests[rid].out_tokens))
                  for rid in sorted(feasible) if rid in eng.requests]
        return ScenarioResult(
            scn.index, "arrivals", not failures, failures, faults, viols,
            _digest(scn.ops, _tx_tuples(eng.mem.log), tokens, viols,
                    [e.key() for e in faults]), len(eng.mem.log.txs))

    # ------------------------------------------------------------ driving
    def run(self, n_scenarios: int) -> FuzzReport:
        results = [self.run_scenario(self.scenario(i))
                   for i in range(n_scenarios)]
        return FuzzReport(self.seed, results, coverage=self.coverage)

    def shrink(self, scn: Scenario, use_replay: bool = True,
               checkpoint_every: int = 4) -> Tuple[Scenario, ScenarioResult]:
        """Minimize a failing scenario to its shortest failing op prefix.

        Execution is deterministic given the seed, so a prefix replays
        identically up to its truncation point.  For bridge scenarios the
        candidate prefixes are materialized by **checkpointed window
        replay** (core/replay.py): each backend's full scenario is
        recorded ONCE with a checkpoint every ``checkpoint_every``
        launches, and prefix-k state is restored from the nearest
        checkpoint instead of re-executing ops 1..k from scratch — O(n)
        total ops instead of the full-re-run-per-prefix O(n²).  The
        winning prefix is then re-run once through ``run_scenario`` for
        an authoritative ``ScenarioResult``.  ``use_replay=False`` (and
        the register/serving layers, whose op cost is trivial) keep the
        linear re-run lane.  ``shrink_counts`` holds the replay lane's
        event counts afterwards."""
        self.shrink_counts = {}
        if use_replay and scn.layer == "bridge" and len(scn.ops) > 1:
            got = self._shrink_bridge_replay(scn, max(1, checkpoint_every))
            if got is not None:
                return got
        for k in range(1, len(scn.ops) + 1):
            sub = Scenario(scn.index, scn.layer, scn.ops[:k])
            res = self.run_scenario(sub)
            if not res.ok:
                return sub, res
        return scn, self.run_scenario(scn)

    # ---------------------------------------------- replay-backed shrinking
    _BRIDGE_EVENTS_PER_OP = 6       # alloc x3 + host_write x2 + launch

    def _record_bridge_scenario(self, scn: Scenario, backend: str,
                                checkpoint_every: int):
        """Record one backend's run of a bridge scenario as a replayable
        timeline, checkpointing every ``checkpoint_every`` scenario ops.
        The event stream mirrors ``_run_bridge`` exactly (same buffer
        names, same fault-plan fork, same burst lists), so prefix state
        restored from a checkpoint is bit-identical to a fresh prefix
        re-run."""
        from repro_torch.core import replay as rp
        table = self._matmul_table()

        def factory():
            plan = self.plan.fork(f"{scn.label}/{backend}",
                                  scenario=scn.index)
            fb = FireBridge(congestion=self.congestion, fault_plan=plan)
            fb.register_op("mm", **table)
            return fb

        def program(rec):
            for j, (_, size) in enumerate(scn.ops):
                rng = np.random.default_rng(size * 1009 + j)
                a = rng.normal(size=(size, size)).astype(np.float32)
                b = rng.normal(size=(size, size)).astype(np.float32)
                rec.do("alloc", f"a{j}", a.shape, np.float32)
                rec.do("alloc", f"b{j}", b.shape, np.float32)
                rec.do("alloc", f"c{j}", (size, size), np.float32)
                rec.do("host_write", f"a{j}", a)
                rec.do("host_write", f"b{j}", b)
                rec.do("launch", "mm", backend, (f"a{j}", f"b{j}"),
                       (f"c{j}",), "mm",
                       lambda s=size: mm_ops.transactions(
                           s, s, s, bm=self.TILE, bn=self.TILE,
                           bk=self.TILE, dtype_bytes=4), {})
                if (j + 1) % checkpoint_every == 0:
                    rec.checkpoint()

        sess = rp.DebugSession(factory, checkpoint_interval=0,
                               label=f"{scn.label}/{backend}")
        return sess, sess.record(program)

    def _shrink_bridge_replay(self, scn: Scenario, checkpoint_every: int
                              ) -> Optional[Tuple[Scenario, ScenarioResult]]:
        """Find the shortest failing launch prefix via checkpointed prefix
        replay + binary search; None defers to the linear lane (e.g. a
        failure mode the prefix probe cannot see).

        The probe (cross-backend output divergence or a logged violation
        in the prefix state) is MONOTONE in prefix length — a diverged
        buffer stays diverged and the violation list only grows — so the
        shortest failing prefix is found in O(log n) probes, each
        restored from the nearest checkpoint instead of re-executed from
        time zero."""
        recs = {b: self._record_bridge_scenario(scn, b, checkpoint_every)
                for b in self.backends}
        per_op = self._BRIDGE_EVENTS_PER_OP

        def probe(k: int) -> bool:
            outs: Dict[str, Dict[str, np.ndarray]] = {}
            bad = False
            for backend, (sess, rec) in recs.items():
                fb = sess.replay(rec, k * per_op, k * per_op).target
                outs[backend] = {n: b.array.copy()
                                 for n, b in fb.mem.buffers.items()}
                bad = bad or bool(fb.log.violations)
                self.shrink_counts[backend] = (sess.ops_applied,
                                               sess.replays)
            return bad or not compare_outputs(outs, tol=self.tol).passed

        n = len(scn.ops)
        if not probe(n):
            return None                       # invisible to the probe —
        lo, hi = 0, n                         # defer to the linear lane
        while hi - lo > 1:                    # invariant: probe(hi) fails
            mid = (lo + hi) // 2
            if probe(mid):
                hi = mid
            else:
                lo = mid
        sub = Scenario(scn.index, scn.layer, scn.ops[:hi])
        res = self.run_scenario(sub)          # authoritative re-check
        if not res.ok:
            return sub, res
        return None                          # probe/result disagree —
                                             # defer to the linear lane


def planted_bug_table(tile: int = ProtocolFuzzer.TILE,
                      index: Tuple[int, int] = (1, 2),
                      delta: float = 1.0,
                      device: Union[str, torch.device] = "cuda") -> dict:
    """Matmul backend table (on ``device``) with a known interpret-mode
    divergence at ``index`` — the planted bug used to demonstrate/verify
    that the fuzz differential check catches and shrinks real backend
    disagreements."""
    table = matmul_backends(tile=tile, device=device)
    good = table["interpret"]

    def buggy(a, b):
        out = np.array(good(a, b))
        out[index] += delta
        return out
    return dict(table, interpret=buggy)


def _default_engine(device: Union[str, torch.device] = "cuda",
                    cfg=None) -> Any:
    """Small smoke-config serving engine for the serving fuzz layer (built
    once per fuzzer; the prefill/decode callables are reused across
    scenarios via ``ServingEngine.reset``).  bf16 weights from a seeded
    generator on ``device``; ``cfg`` replaces the smoke llama3.2-1b config
    (at full width, say) and keeps the engine geometry."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models.transformer import RunFlags, init_params
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else smoke(get_config("llama3.2-1b"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    return ServingEngine(cfg, params, max_slots=3, max_len=32, prompt_pad=8,
                         flags=RunFlags(attn_impl="chunked", q_chunk=16,
                                        kv_chunk=16), device=dev)


def run_fuzz(seed: int = 0, n_scenarios: int = 50,
             layers: Sequence[str] = ("bridge", "registers"),
             **kw) -> FuzzReport:
    """One-call fuzz run: ``run_fuzz(0, 200, layers=(...,"serving"))``."""
    return ProtocolFuzzer(seed=seed, layers=layers, **kw).run(n_scenarios)
