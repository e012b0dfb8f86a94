"""Seeded open-loop arrival processes + the open-loop serving loop —
the port of ``repro.serving.arrivals`` (value-free).

Closed-loop storms (``run_until_done`` after a burst of submissions) only
exercise the engine at its own pace.  Open-loop load — the traffic shape
of millions of users — keeps arriving whether or not the engine kept up,
so queueing delay, deferred admission, and SLO percentiles become
observable.  This module provides the stimulus side:

* ``poisson_trace`` / ``bursty_trace`` / ``replayed_trace`` build an
  ``ArrivalTrace``: request ids, arrival times (modeled cycles), prompts,
  and token budgets, all a **pure function of the seed** (numpy
  ``default_rng``) — same seed, same trace, on any machine at any worker
  count.  ``fork()`` derives child traces by the same sha256 construction
  as ``FaultPlan.fork`` / ``runfarm.units.fork_seed``, so run-farm
  campaigns can shard arrival-trace sweeps without coordination.
* ``drive_open_loop`` is THE open-loop decision loop (the replay
  recorder, ``core/replay.py::open_loop_program``, shares it): at each
  scheduler tick it submits every
  arrival whose time has come through the CSR protocol (prompt poke,
  SUBMIT_*, DOORBELL), steps the engine, and fast-forwards the modeled
  clock over idle gaps.  Submission instants depend only on the engine's
  deterministic clock, so the emitted event sequence is itself
  deterministic.

Works against a ``ServingEngine`` or ``ClusterServingEngine`` in
continuous-batching mode (both expose ``clock`` / ``advance_clock``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Arrival", "ArrivalTrace", "fork_seed", "poisson_trace",
    "bursty_trace", "replayed_trace", "build_trace", "ARRIVAL_KINDS",
    "drive_open_loop", "run_open_loop",
]


def fork_seed(seed: int, label: str) -> int:
    """Deterministic child seed — identical construction to
    ``FaultPlan.fork`` (core/fuzz.py) and ``runfarm.units.fork_seed``,
    so arrival-trace lineages are order- and process-independent."""
    return int.from_bytes(
        hashlib.sha256(f"{seed}/{label}".encode()).digest()[:8], "little")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: arrives at ``time`` (modeled cycles),
    carries its prompt tokens and decode budget."""
    rid: int
    time: float
    prompt: Tuple[int, ...]
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A seed-closed arrival process realization.  ``kind``/``seed``/
    ``params`` fully determine ``arrivals`` for the generated kinds, so
    the trace ships as three JSON-friendly fields (runfarm unit params)
    and regenerates anywhere."""
    kind: str
    seed: int
    params: Tuple[Tuple[str, Any], ...]
    arrivals: Tuple[Arrival, ...]

    @property
    def label(self) -> str:
        return f"{self.kind}/s{self.seed}/n{len(self.arrivals)}"

    def digest(self) -> str:
        """sha256 over the canonical arrival lines (stimulus witness)."""
        h = hashlib.sha256()
        h.update(f"{self.kind}/{self.seed}".encode())
        for a in self.arrivals:
            h.update(f"{a.rid},{a.time:.6f},{a.max_new_tokens},"
                     f"{','.join(map(str, a.prompt))}\n".encode())
        return h.hexdigest()

    def fork(self, label: str) -> "ArrivalTrace":
        """Child trace: same process shape, seed forked by ``label``
        (sha256 — worker/order independent).  Generated kinds only."""
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"cannot fork a {self.kind!r} trace "
                             f"(explicit arrivals carry no seed)")
        return build_trace(self.kind, fork_seed(self.seed, label),
                           **dict(self.params))

    def total_tokens(self) -> int:
        return sum(a.max_new_tokens for a in self.arrivals)


def _mk_arrivals(times: np.ndarray, rng: np.random.Generator, *,
                 prompt_lens: Tuple[int, int], max_new: Tuple[int, int],
                 vocab: int, rid_base: int) -> Tuple[Arrival, ...]:
    out = []
    for i, t in enumerate(times):
        ln = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        mx = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, vocab, size=ln))
        out.append(Arrival(rid_base + i, float(round(t, 6)), prompt, mx))
    return tuple(out)


def poisson_trace(seed: int, *, n_requests: int = 8,
                  mean_gap: float = 200.0,
                  prompt_lens: Tuple[int, int] = (3, 12),
                  max_new: Tuple[int, int] = (1, 6),
                  vocab: int = 512, rid_base: int = 0) -> ArrivalTrace:
    """Poisson process: exponential inter-arrival gaps with mean
    ``mean_gap`` modeled cycles."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(mean_gap, size=n_requests))
    params = (("n_requests", n_requests), ("mean_gap", mean_gap),
              ("prompt_lens", tuple(prompt_lens)),
              ("max_new", tuple(max_new)), ("vocab", vocab),
              ("rid_base", rid_base))
    return ArrivalTrace("poisson", seed, params,
                        _mk_arrivals(times, rng, prompt_lens=prompt_lens,
                                     max_new=max_new, vocab=vocab,
                                     rid_base=rid_base))


def bursty_trace(seed: int, *, n_requests: int = 8,
                 burst_size: int = 4, gap_in_burst: float = 10.0,
                 gap_between: float = 1500.0,
                 prompt_lens: Tuple[int, int] = (3, 12),
                 max_new: Tuple[int, int] = (1, 6),
                 vocab: int = 512, rid_base: int = 0) -> ArrivalTrace:
    """ON-OFF (bursty) process: bursts of up to ``burst_size`` requests
    ``gap_in_burst`` cycles apart, separated by exponential OFF periods
    with mean ``gap_between`` — the hostile shape where a whole burst
    lands on a drained engine at once."""
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = 0.0
    while len(times) < n_requests:
        t += float(rng.exponential(gap_between))
        n = int(rng.integers(1, burst_size + 1))
        for j in range(min(n, n_requests - len(times))):
            times.append(t + j * gap_in_burst)
    params = (("n_requests", n_requests), ("burst_size", burst_size),
              ("gap_in_burst", gap_in_burst), ("gap_between", gap_between),
              ("prompt_lens", tuple(prompt_lens)),
              ("max_new", tuple(max_new)), ("vocab", vocab),
              ("rid_base", rid_base))
    return ArrivalTrace("bursty", seed, params,
                        _mk_arrivals(np.asarray(times), rng,
                                     prompt_lens=prompt_lens,
                                     max_new=max_new, vocab=vocab,
                                     rid_base=rid_base))


def replayed_trace(entries: Sequence[Tuple[int, float, Sequence[int], int]]
                   ) -> ArrivalTrace:
    """Explicit (replayed) arrival trace from ``(rid, time, prompt,
    max_new_tokens)`` entries — captured production traffic, a fuzz
    scenario's hostile stream, or a hand-written regression case.
    Entries are sorted by (time, rid) into canonical arrival order."""
    arrivals = tuple(sorted(
        (Arrival(int(rid), float(t), tuple(int(x) for x in prompt),
                 int(mx)) for rid, t, prompt, mx in entries),
        key=lambda a: (a.time, a.rid)))
    return ArrivalTrace("replay", 0, (("n_requests", len(arrivals)),),
                        arrivals)


ARRIVAL_KINDS: Dict[str, Callable[..., ArrivalTrace]] = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
}


def build_trace(kind: str, seed: int, **params: Any) -> ArrivalTrace:
    """Registry entry point (runfarm units / fuzz scenarios build traces
    from JSON params through here)."""
    try:
        make = ARRIVAL_KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown arrival kind {kind!r} "
                       f"(known: {sorted(ARRIVAL_KINDS)})") from None
    return make(seed, **params)


# ---------------------------------------------------------- the open loop
def drive_open_loop(do: Callable[..., Any], target: Any,
                    trace: ArrivalTrace, max_ticks: int = 200_000) -> int:
    """THE open-loop decision loop, parameterized by the event sink:
    ``do(kind, *args)`` either applies directly (``run_open_loop``) or
    records + applies (``replay.open_loop_program``) — one loop, so the
    live and recorded stimulus cannot drift.

    Per iteration: submit every arrival due at the target's current
    modeled clock through the CSR protocol, then either step the
    scheduler (work pending/active) or fast-forward the clock to the next
    arrival (idle).  Returns the number of scheduler ticks driven.
    """
    pending = (target._n_pending if hasattr(target, "engines")
               else (lambda: len(target.pending)))
    arrivals = sorted(trace.arrivals, key=lambda a: (a.time, a.rid))
    i, ticks = 0, 0
    while i < len(arrivals) or pending() or target._n_active():
        now = target.clock
        while i < len(arrivals) and arrivals[i].time <= now:
            a = arrivals[i]
            i += 1
            do("host_poke", "prompt_in", np.asarray(a.prompt, np.int32))
            do("csr_write", "SUBMIT_ID", int(a.rid))
            do("csr_write", "SUBMIT_LEN", len(a.prompt))
            do("csr_write", "SUBMIT_MAXNEW", int(a.max_new_tokens))
            do("csr_write", "DOORBELL", 1)
        if not pending() and not target._n_active():
            if i >= len(arrivals):
                # every arrival submitted, none admitted still in flight
                # (the tail was rejected at the doorbell): drained
                break
            # drained with arrivals still ahead: fast-forward the modeled
            # clock over the idle gap (the open-loop source keeps its own
            # time — the engine does not get to slow it down)
            do("advance", float(arrivals[i].time))
            continue
        do("step")
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(
                f"open-loop run did not drain within {max_ticks} ticks "
                f"({pending()} pending, {target._n_active()} active)")
    return ticks


def run_open_loop(target: Any, trace: ArrivalTrace,
                  max_ticks: int = 200_000) -> int:
    """Drive ``trace`` against a live engine (continuous-batching mode)
    without recording; returns the scheduler-tick count.  Events are
    funneled through ``replay.apply_event`` — the exact executor a
    recorded run replays through."""
    from repro_torch.core.replay import TimelineEvent, apply_event

    def do(kind: str, *args: Any) -> Any:
        return apply_event(target, TimelineEvent(kind, args))

    return drive_open_loop(do, target, trace, max_ticks)
