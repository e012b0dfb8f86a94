"""Continuous-batching serving engine driven through a FireBridge
register-file control plane (paper §IV-A adapted to an inference server) —
the port of ``repro.serving.engine``.

Hardware-style interface: firmware submits a request by writing its prompt
into a bridge DDR buffer, programming SUBMIT_* CSRs, and ringing the
DOORBELL; it polls STATUS/COMPLETED and reads generated tokens back from
DDR.  Internally the engine runs batched prefill/decode with slot-based
continuous batching over a shared KV/state cache (``cache_insert``).

The control plane (CSR map, scheduler, KV paging, counters, transaction
log) is the reference's, line for line: its log digest and CSR log are the
same for the same request stream.  Prefill and decode are plain callables
(``make_prefill_fn`` / ``make_decode_fn``) where the reference jits them;
``jit_fns`` shares one pair of them across the device-local engines of a
``ClusterServingEngine``, as the reference shares its executables.
``profiler()`` and ``get_state`` / ``set_state`` serve the data-movement
profiler and time-travel replay.  Under a sharding context (``ctx``) the
parameters are placed by ``prefill_shardings`` (unless they are DTensors
already) and the cache lives as DTensors in ``decode_shardings``' layout,
made from local zeros: each rank holds its shard and never the whole.  A
prefill computes one request on every rank and returns its shard of the
one-row cache, which ``cache_insert`` writes into the rows of the
data shard that owns the slot; a decode step hands ``make_decode_fn`` the
local shards, keeps what comes back as the local shards of the same
layout, takes the argmax of its rows' logits and gathers the (B,) token
ids over the data axes (see ``make_decode_fn``).  The control plane is
the same on every rank.  The cache and the parameters live on ``device``
(default ``"cuda"``), and the argmax tokens come back to the host as in
the reference.  For the ssm and
hybrid families the prefill
runs the WKV-6 / SSD scan kernels; as in the reference, a prompt of those
families should be a multiple of ``prompt_pad`` long, or the left padding
perturbs the state.  A vlm prefill gets zero patch embeddings
(``_batchify``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.bridge import MemoryBridge
from repro_torch.core.congestion import CongestionConfig, CongestionResult
from repro_torch.core.counters import CounterBank, CounterSpec
from repro_torch.core.registers import RO, RegisterFile
from repro_torch.launch.steps import decode_shardings, prefill_shardings
from repro_torch.models.transformer import (RunFlags, cache_insert,
                                            cache_layout, init_cache,
                                            make_decode_fn, make_prefill_fn)
from repro_torch.serving.kvpool import KVPool
from repro_torch.sharding import comm
from repro_torch.sharding.specs import (from_local_tree, is_sharded,
                                        local_tree, map_specs, place)

CTRL, STATUS, DOORBELL = 0x00, 0x04, 0x08
SUBMIT_ID, SUBMIT_LEN, SUBMIT_MAXNEW = 0x0C, 0x10, 0x14
COMPLETED, ACTIVE = 0x18, 0x1C


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle stamps on the engine's modeled clock (continuous-batching
    # mode; -1.0 = not reached).  serving/slo.py reads them into the SLO
    # report: queueing = admit - arrival, TTFT = first - arrival.
    t_submit: float = -1.0
    t_admit: float = -1.0
    t_first: float = -1.0
    t_done: float = -1.0


def _copy_request(r: "Request") -> "Request":
    return Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                   list(r.out_tokens), r.done, r.t_submit, r.t_admit,
                   r.t_first, r.t_done)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_len: int = 256,
                 flags: RunFlags = RunFlags(microbatches=1),
                 ctx=None,
                 prompt_pad: int = 16,
                 congestion: Optional[CongestionConfig] = None,
                 fault_plan=None,
                 batching: str = "storm",
                 kv_pages: Optional[int] = None,
                 kv_page_size: int = 16,
                 kv_leak_every: int = 0,
                 step_cycles: float = 64.0,
                 jit_fns=None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.flags = flags
        self.prompt_pad = prompt_pad
        self.congestion = congestion
        # scheduling mode: "storm" is the closed-loop tick (admit ONE
        # request or decode — the committed golden traces); "continuous"
        # is the open-loop tick (admit as many as slots AND KV pages allow,
        # then decode the whole batch) with a modeled clock advanced by
        # per-step costs — serving/arrivals.py drives it
        if batching not in ("storm", "continuous"):
            raise ValueError(f"unknown batching mode {batching!r}")
        self.batching = batching
        # KV paging (serving/kvpool.py): kv_pages=None runs unpaged;
        # kv_leak_every is the planted late-firing paging bug
        self.kv_pages = kv_pages
        self.kv_page_size = kv_page_size
        self.kv_leak_every = kv_leak_every
        # modeled cost of one decode step (and of one prompt bucket of
        # prefill) on the engine clock, in cycles
        self.step_cycles = float(step_cycles)

        self.ctx = ctx
        self._cache_sh = self._cache_shape = None
        if ctx is not None:
            shape = ShapeConfig("serve", max_len, max_slots, "decode")
            if not is_sharded(params):
                self.params = place(params, prefill_shardings(
                    cfg, shape, ctx.mesh, ctx)[1])
            _, _, self._cache_shape, self._cache_sh, _, _ = \
                decode_shardings(cfg, shape, ctx.mesh, ctx)
        if jit_fns is not None:
            self._prefill, self._decode = jit_fns
        else:
            self._prefill = make_prefill_fn(cfg, flags, ctx, max_len)
            self._decode = make_decode_fn(cfg, flags, ctx, max_len)
        self.reset(fault_plan=fault_plan)

    @property
    def jit_fns(self):
        """The shareable (prefill, decode) callable pair."""
        return (self._prefill, self._decode)

    def reset(self, fault_plan=None, **overrides) -> None:
        """Restore fresh-engine state (cache, slots, queues, control plane,
        KV page pool, modeled clock) while keeping the prefill/decode
        callables.  ``fault_plan`` routes the engine's prompt/token DMA
        through bridge-level fault injection.  ``overrides`` reconfigures
        the scheduling axes for the rerun: ``batching``, ``kv_pages``,
        ``kv_page_size``, ``kv_leak_every``, ``step_cycles``."""
        for key in ("batching", "kv_pages", "kv_page_size",
                    "kv_leak_every", "step_cycles"):
            if key in overrides:
                setattr(self, key, overrides.pop(key))
        if overrides:
            raise TypeError(f"unknown reset overrides: {sorted(overrides)}")
        self.cache = self._empty_cache()
        self.slots: List[Optional[Request]] = [None] * self.max_slots
        self.pending: deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self.completed = 0
        self.clock = 0.0
        self.kv_pool: Optional[KVPool] = (
            KVPool(self.kv_pages, self.kv_page_size,
                   leak_every=self.kv_leak_every)
            if self.kv_pages is not None else None)

        # control plane; with `congestion` the prompt/token DMA traffic is
        # arbitrated online through the shared-link model (paper §IV-C)
        self.mem = MemoryBridge(congestion=self.congestion,
                                fault_plan=fault_plan)
        self.csr = RegisterFile("serve.csr", self.mem.log)
        self.csr.define("CTRL", CTRL)
        self.csr.define("STATUS", STATUS, access=RO)
        self.csr.define("DOORBELL", DOORBELL, on_write=self._on_doorbell)
        self.csr.define("SUBMIT_ID", SUBMIT_ID)
        self.csr.define("SUBMIT_LEN", SUBMIT_LEN)
        self.csr.define("SUBMIT_MAXNEW", SUBMIT_MAXNEW)
        self.csr.define("COMPLETED", COMPLETED, access=RO)
        self.csr.define("ACTIVE", ACTIVE, access=RO)
        self.mem.alloc("prompt_in", (self.max_len,), np.int32)
        self.mem.alloc("tokens_out", (self.max_slots, self.max_len),
                       np.int32)

        # always-on sampled counters (core/counters.py): functional-scope
        # doorbells / requests / tokens retired, timing-scope KV gauges;
        # rebuilt here because the pool and bridge are rebuilt on reset
        self.counters = CounterBank("serving")
        self.counters.register(
            CounterSpec("doorbells", "events", scope="functional"))
        self.counters.register(
            CounterSpec("requests_retired", "events", scope="functional"))
        self.counters.register(
            CounterSpec("tokens_retired", "tokens", scope="functional"))
        if self.kv_pool is not None:
            pool = self.kv_pool
            self.counters.register(
                CounterSpec("kv_pages_in_use", "pages", monotone=False),
                lambda: pool.in_use)
            self.counters.register(CounterSpec("kv_peak_pages", "pages"),
                                   lambda: pool.peak_in_use)
            self.counters.register(CounterSpec("kv_deferrals", "events"),
                                   lambda: pool.deferrals)
            self.counters.register(CounterSpec("kv_releases", "events"),
                                   lambda: pool.releases)

    # -------------------------------------------------- register protocol
    def _on_doorbell(self, _data: int) -> None:
        self.counters.inc("doorbells")
        rid = self.csr.hw_get("SUBMIT_ID")
        ln = self.csr.hw_get("SUBMIT_LEN")
        mx = self.csr.hw_get("SUBMIT_MAXNEW")
        if ln <= 0 or ln > self.max_len:
            self.csr.log.violation(f"SUBMIT_LEN out of range: {ln}")
            return
        if self.batching == "continuous":
            # keep the DMA time domain and the engine clock in lockstep
            self.mem.time = max(self.mem.time, self.clock)
        prompt = self.mem.dev_read("prompt_in", engine="serve_dma")[:ln]
        if self.batching == "continuous":
            self.clock = max(self.clock, self.mem.time)
        self.submit(Request(rid, prompt.astype(np.int32), mx))

    # ---------------------------------------------------------- scheduler
    def submit(self, req: Request) -> None:
        """Enqueue one request; rejects (with a logged violation, never a
        silent overwrite) non-positive token budgets and duplicate ids."""
        if req.max_new_tokens <= 0:
            self.csr.log.violation(
                f"SUBMIT_MAXNEW must be positive: {req.max_new_tokens} "
                f"(request {req.rid})")
            return
        # ids may be recycled once their request retired; only an
        # in-flight duplicate is a violation
        existing = self.requests.get(req.rid)
        if existing is not None and not existing.done:
            self.csr.log.violation(
                f"duplicate SUBMIT_ID {req.rid}: request still in flight")
            return
        # KV-cache capacity: prefill occupies the padded prompt bucket and
        # each decode step appends one entry
        pl = self._pad_len(len(req.prompt))
        if (len(req.prompt) > self.max_len
                or pl + req.max_new_tokens - 1 > self.max_len):
            self.csr.log.violation(
                f"request {req.rid} exceeds KV capacity: padded prompt "
                f"{pl} + {req.max_new_tokens} new tokens > max_len "
                f"{self.max_len}")
            return
        # page-pool feasibility: a request that could never be admitted is
        # rejected at the doorbell (deferring it would livelock the FIFO)
        if self.kv_pool is not None and \
                not self.kv_pool.fits(pl + req.max_new_tokens - 1):
            self.csr.log.violation(
                f"request {req.rid} exceeds KV page pool: "
                f"{self.kv_pool.pages_for(pl + req.max_new_tokens - 1)} "
                f"pages needed > {self.kv_pool.n_pages} total")
            return
        req.t_submit = self.clock
        self.pending.append(req)
        self.requests[req.rid] = req

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _pad_len(self, n: int) -> int:
        p = self.prompt_pad
        return min(self.max_len, -(-n // p) * p)

    def step(self) -> int:
        """One scheduler tick (storm: admit one pending request OR run one
        batched decode step; continuous: admit as many as slots and KV
        pages allow, then decode the whole batch).  Returns the number of
        active slots."""
        n = (self._step_continuous() if self.batching == "continuous"
             else self._step_storm())
        self.counters.tick(max(self.clock, self.mem.time))
        return n

    def _step_storm(self) -> int:
        slot = self._free_slot()
        if self.pending and slot is not None:
            req = self.pending.popleft()
            self._prefill_admit(slot, req)
            self.csr.hw_set("ACTIVE", self._n_active())
            return self._n_active()

        if self._n_active():
            self._decode_step()
            self.csr.hw_set("ACTIVE", self._n_active())
        return self._n_active()

    def _prefill_admit(self, slot: int, req: Request) -> None:
        """Prefill ``req`` into ``slot``: bucket-padded prefill, cache
        insert, first-token emit."""
        # Left-pad to the prefill bucket; pad keys are masked out below
        # (exact for attention families; for ssm/hybrid the leading pad
        # tokens perturb the state unless the prompt is a bucket multiple)
        pl = self._pad_len(len(req.prompt))
        pad_n = pl - len(req.prompt)
        toks = np.zeros((1, pl), np.int32)
        toks[0, pad_n:] = req.prompt
        logits, single = self._prefill(
            self.params,
            self._batchify({"tokens": torch.from_numpy(toks).to(self.device)}))
        specs = None if self.ctx is None else (
            cache_layout(self.cfg, self.ctx, self.max_slots,
                         self.max_len)[1],
            cache_layout(self.cfg, self.ctx, 1, self.max_len, pl)[1])
        cache_insert(local_tree(self.cache), single, slot, pad=pad_n,
                     ctx=self.ctx, specs=specs)
        self.slots[slot] = req
        first = int(torch.argmax(logits[0]))
        req.out_tokens.append(first)
        # the prefill itself emits one token: a max_new_tokens=1 request
        # is complete right here
        if len(req.out_tokens) >= req.max_new_tokens:
            self._retire(slot)

    def _empty_cache(self) -> dict:
        """A fresh cache; under a context, DTensors over local zeros, no
        whole tensor made."""
        if self.ctx is None:
            return init_cache(self.cfg, self.max_slots, self.max_len,
                              device=self.device)

        def local(sh, t):
            # init_cache's values: -1 in kv_pos and win_pos (its int32
            # leaves of more than one dim), 0 elsewhere
            idx = sh.local_index(tuple(t.shape), sh.mesh.coordinate())
            return torch.full([s.stop - s.start for s in idx],
                              -1 if t.dtype == torch.int32 and t.dim() > 1
                              else 0, dtype=t.dtype, device=self.device)
        return from_local_tree(
            map_specs(local, self._cache_sh, self._cache_shape),
            self._cache_sh, self._cache_shape)

    def _decode_step(self) -> None:
        """One batched decode step over all occupied slots."""
        toks = np.zeros((self.max_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                toks[i] = s.out_tokens[-1] % self.cfg.vocab_size
        toks = torch.from_numpy(toks).to(self.device)
        if self.ctx is None:
            logits, self.cache = self._decode(self.params, self.cache, toks)
            nxt = torch.argmax(logits, dim=-1)
        else:
            logits, cache = self._decode(self.params,
                                         local_tree(self.cache), toks)
            self.cache = from_local_tree(cache, self._cache_sh,
                                         self._cache_shape)
            # this rank's rows' tokens, then the (B,) ids of all rows
            nxt = torch.argmax(logits, dim=-1)
            if logits.shape[0] < self.max_slots:
                nxt = comm.gather_data(nxt, self.ctx)
        nxt = nxt.cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.out_tokens.append(int(nxt[i]))
            if len(s.out_tokens) >= s.max_new_tokens:
                self._retire(i)

    def _step_continuous(self) -> int:
        """Continuous-batching tick: FIFO admission (no head-of-line
        bypass) up to slot/page limits, then one batched decode over
        everything resident.  The modeled clock pays ``step_cycles`` per
        prompt bucket of prefill and per decode step."""
        admitted = 0
        while self.pending:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.pending[0]
            pl = self._pad_len(len(req.prompt))
            if self.kv_pool is not None and not self.kv_pool.reserve(
                    req.rid, pl + req.max_new_tokens - 1):
                break       # FIFO: deferred head blocks the queue
            self.pending.popleft()
            req.t_admit = self.clock
            self.clock += self.step_cycles * max(1, pl // self.prompt_pad)
            req.t_first = self.clock
            self._prefill_admit(slot, req)
            admitted += 1
        if self._n_active():
            self.clock += self.step_cycles
            self._decode_step()
        elif not admitted and self.pending:
            # nothing runnable (pages short of the FIFO head — only under
            # an injected leak): modeled time still progresses
            self.clock += self.step_cycles
        self.csr.hw_set("ACTIVE", self._n_active())
        return self._n_active()

    def advance_clock(self, t: float) -> None:
        """Fast-forward the modeled clock to ``t`` (never backwards)."""
        self.clock = max(self.clock, float(t))
        self.counters.tick(max(self.clock, self.mem.time))

    def _retire(self, i: int) -> None:
        """Complete slot i: tokens_out DMA writeback, slot free,
        COMPLETED CSR update."""
        s = self.slots[i]
        s.done = True
        s.t_done = self.clock
        self.counters.inc("requests_retired")
        self.counters.inc("tokens_retired", len(s.out_tokens))
        if self.kv_pool is not None:
            self.kv_pool.release(s.rid)
        # row-sized DMA writeback: only slot i's tokens move
        buf = self.mem.buffers["tokens_out"]
        buf.array[i, :len(s.out_tokens)] = s.out_tokens
        row = buf.array[i]
        if self.batching == "continuous":
            self.mem.log_burst_list(
                [("serve_dma", "write",
                  buf.addr + i * row.nbytes, row.nbytes)],
                base_time=max(self.mem.time, self.clock))
            self.clock = max(self.clock, self.mem.time)
        else:
            self.mem.log_burst_list(
                [("serve_dma", "write",
                  buf.addr + i * row.nbytes, row.nbytes)])
        self.slots[i] = None
        self.completed += 1
        self.csr.hw_set("COMPLETED", self.completed)

    def _n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def congestion_stats(self) -> Optional[CongestionResult]:
        """Fig. 8 stall statistics of the serving DMA traffic (None when
        the engine runs congestion-free)."""
        return self.mem.congestion_stats()

    def _batchify(self, batch):
        """A vlm prefill's image input: zero patch embeddings, as in the
        reference (its vision frontend is a stub)."""
        if self.cfg.frontend == "tokens+patches":
            batch["patches"] = torch.zeros(
                (1, self.cfg.n_media_tokens, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        return batch

    def counter_banks(self):
        """The serving-lifecycle bank plus the DMA bridge's link bank."""
        return [self.counters, self.mem.counters]

    def profiler(self, label: str = "serving"):
        """Data-movement profile of the serving DMA traffic
        (core/profiler.py): prompt-upload vs token-writeback attribution
        rides on the ``serve_dma`` read/write split
        (``DataMovementProfiler.serving_rows``)."""
        from repro_torch.core.profiler import DataMovementProfiler
        return DataMovementProfiler(self, label=label)

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> dict:
        """Engine snapshot at a scheduler-tick boundary: KV/state cache,
        request table, slot map, pending queue, and the control plane.
        Decode and ``cache_insert`` write the cache in place, so the
        snapshot holds a copy of every cache tensor (one copy a snapshot,
        not one a step).  Requests are copied by rid so the
        slots/pending/requests aliasing survives the round-trip."""
        reqs = {rid: _copy_request(r) for rid, r in self.requests.items()}
        return {
            "cache": tree_map(torch.clone, self.cache),
            "requests": reqs,
            "slots": [s.rid if s is not None else None for s in self.slots],
            "pending": [r.rid for r in self.pending],
            "completed": self.completed,
            "clock": self.clock,
            "kv_pool": (self.kv_pool.get_state()
                        if self.kv_pool is not None else None),
            "mem": self.mem.get_state(),    # includes the shared log
            "csr": self.csr.get_state(),
            "counters": self.counters.get_state(),
        }

    def set_state(self, state: dict) -> None:
        # a copy: the snapshot stays as it was for the next restore
        self.cache = tree_map(torch.clone, state["cache"])
        self.requests = {rid: _copy_request(r)
                         for rid, r in state["requests"].items()}
        self.slots = [self.requests[rid] if rid is not None else None
                      for rid in state["slots"]]
        self.pending = deque(self.requests[rid] for rid in state["pending"])
        self.completed = state["completed"]
        self.clock = state.get("clock", 0.0)
        pool_state = state.get("kv_pool")
        if pool_state is not None and self.kv_pool is not None:
            self.kv_pool.set_state(pool_state)
        self.mem.set_state(state["mem"])
        self.csr.set_state(state["csr"])
        cs = state.get("counters")
        if cs is not None:
            self.counters.set_state(cs)

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        self.csr.hw_set("STATUS", 1)
        for _ in range(max_ticks):
            if not self.pending and self._n_active() == 0:
                break
            self.step()
        self.csr.hw_set("STATUS", 2)
