"""Always-on AutoCounter-style sampled performance counters (ROADMAP 5).

FireSim leaves AutoCounter/TracerV instrumentation compiled into every
simulation: out-of-band counters sampled on a fixed interval, cheap
enough to stay on across a whole run-farm campaign.  This module is the
modeled-time analogue: every bridge / fabric link / switch port /
serving engine registers a ``CounterBank`` of named counters, and the
bank samples them into an append-only columnar ``CounterStream`` each
time the owner's modeled clock crosses an interval boundary.

Design rules (each one is load-bearing for a regression tier):

* **Counters never perturb the model.**  A probe only reads state the
  owner already maintains; sampling happens after the owner's clock has
  advanced.  Timing, RNG draws and transaction logs are bit-identical
  with counters on or off — the seven golden traces are the witness.
* **Sampling is boundary-based.**  ``tick(now)`` emits one row per
  interval boundary crossed since the last tick (boundaries at k*I,
  computed by multiplication, never accumulation), every row carrying
  the values probed at tick time.  Tick times depend only on the model,
  not on the interval, so a stream sampled at 2I is exactly the
  even-boundary subsequence of the stream sampled at I
  (tests/test_counters.py::test_sampling_interval_invariance).
* **Same lazy-digest discipline as ``TransactionLog``.**  Canonical
  lines and the running sha256 are cached append-only; ``set_state``
  (the one non-append mutation) invalidates them and bumps an epoch so
  a restored stream can never alias a stale memo.
* **Two digest scopes** mirror replay's state/functional fingerprint
  split.  ``digest()`` covers the full sampled stream and is invariant
  across backends at a fixed device count (modeled timing is
  backend-invariant).  Counters declared ``scope="functional"``
  (tokens retired, requests retired, doorbells) have cumulative totals
  that are additionally invariant across 1/2/4 devices;
  ``functional_digest`` hashes those totals summed by name across
  banks.  Together they form the counter-diff oracle wired into
  ``CoVerifySession`` — a digest comparison that runs before (and is
  far cheaper than) full output/trace comparison.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# Default sampling interval in modeled cycles.  A power of two so that
# coarser test intervals (2x, 4x) hit bit-identical boundary values.
DEFAULT_INTERVAL = 256.0

# Module-level always-on switch.  Only the A/B overhead benchmark
# (benchmarks/bench_counters.py) turns sampling off; everything else
# runs with counters on, which is the point of the instrument.
_ENABLED = True


@contextlib.contextmanager
def sampling_disabled():
    """Turn off counter sampling for the duration of the block — the
    counters-off arm of the overhead benchmark.  Banks still exist and
    owned counters still increment (they are plain int adds on state the
    owner carries anyway); only the per-tick sampling stops."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


@dataclasses.dataclass(frozen=True)
class CounterSpec:
    """One declared counter.

    ``unit`` is documentation + dtype: ``cycles`` counters are floats
    (modeled time), everything else is an integer count.  ``scope``
    selects the digest a counter participates in: ``timing`` counters
    are per-run/per-scale (stall cycles, KV pages), ``functional``
    counters have scale-invariant cumulative totals (tokens retired).
    ``monotone`` declares that samples never decrease — asserted for
    every monotone counter by the hypothesis property tier; gauges like
    KV pages in use opt out."""
    name: str
    unit: str = "events"            # events | bytes | cycles | pages | tokens
    scope: str = "timing"           # timing | functional
    monotone: bool = True

    @property
    def is_float(self) -> bool:
        return self.unit == "cycles"


class CounterStream:
    """Append-only columnar sample stream with an incremental digest.

    Rows are (boundary_time, values...) tuples appended by the owning
    bank's ``tick``.  Rendering and hashing follow ``TransactionLog``'s
    lazy-digest discipline exactly: ``_lines``/``_hash`` cover a prefix
    and extend append-only; ``set_state`` clears them and bumps
    ``_epoch`` so the keyed digest memo can never serve a stale value.
    """

    def __init__(self, specs: Tuple[CounterSpec, ...]) -> None:
        self.specs = specs
        self.times: List[float] = []
        self.rows: List[Tuple] = []
        self._lines: List[str] = []
        self._hash = hashlib.sha256()
        self._digest_memo: Optional[Tuple[Tuple, str]] = None
        self._epoch = 0

    @property
    def n_samples(self) -> int:
        return len(self.times)

    def append(self, boundary: float, values: Tuple) -> None:
        self.times.append(boundary)
        self.rows.append(values)

    def extend(self, boundaries: List[float], values: Tuple) -> None:
        """One row of ``values`` at each of ``boundaries``."""
        self.times.extend(boundaries)
        self.rows.extend([values] * len(boundaries))

    # ------------------------------------------------- canonical rendering
    def _render(self) -> None:
        """Render the samples appended since the last call: the time, then
        each value, floats to 6 decimals (``%.6f``, as ``f"{v:.6f}"``)
        and the rest as ``str`` (``%s``), one line a sample.  One format
        string for the stream, the values of a row rendered once for the
        run of samples that hold it (``CounterBank.tick`` appends one row
        object at every boundary it crosses), and one hash update a
        batch: a long fabric run samples millions of rows, and this is
        its host cost."""
        done = len(self._lines)
        if done == len(self.times):
            return
        fmt = " ".join("%.6f" if s.is_float else "%s" for s in self.specs)
        new = []
        last, tail = None, ""
        for t, row in zip(self.times[done:], self.rows[done:]):
            if row is not last:
                last, tail = row, " " + fmt % tuple(row)
            new.append("%.6f" % t + tail)
        self._hash.update(("\n".join(new) + "\n").encode())
        self._lines.extend(new)

    def canonical(self) -> List[str]:
        """Stable one-line-per-sample rendering (floats fixed to 6
        decimals, like ``TransactionLog.canonical_line``) — the golden
        counter-corpus format (tests/golden/*.counters)."""
        self._render()
        return list(self._lines)

    def digest(self) -> str:
        """sha256 over the canonical stream — the counter-diff oracle's
        per-stream witness.  Digest-on-demand: repeat calls cost only
        the samples appended since the last one."""
        key = (self._epoch, len(self.times))
        if self._digest_memo is not None and self._digest_memo[0] == key:
            return self._digest_memo[1]
        self._render()
        out = self._hash.hexdigest()
        self._digest_memo = (key, out)
        return out

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        return {"times": list(self.times), "rows": list(self.rows)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.times[:] = state["times"]
        self.rows[:] = state["rows"]
        self._lines = []
        self._hash = hashlib.sha256()
        self._digest_memo = None
        self._epoch += 1


class CounterBank:
    """A named set of counters sampled on one modeled clock.

    Counters are either *probed* (a zero-argument callable reading state
    the owner already maintains — link byte totals, KV pool occupancy)
    or *owned* (event counters the owner bumps via ``inc`` — doorbells,
    tokens retired; owned values live in the bank so they ride
    ``get_state``/``set_state`` with everything else).

    ``tick(now)`` is the only hot-path entry: one multiply + compare
    when no boundary was crossed, otherwise a single probe pass shared
    by every row emitted (a clock jump over k boundaries yields k rows
    with identical values — sample-and-hold, which keeps the coarser-
    interval stream an exact subsequence of the finer one).
    """

    def __init__(self, name: str, interval: float = DEFAULT_INTERVAL) -> None:
        if interval <= 0:
            raise ValueError(f"counter interval must be > 0, got {interval}")
        self.name = name
        self.interval = float(interval)
        self.specs: List[CounterSpec] = []
        self._probes: List[Optional[Callable[[], Any]]] = []
        self._owned: Dict[str, Any] = {}
        self._k = 1                       # next boundary is interval * _k
        self.stream = CounterStream(())

    # ------------------------------------------------------- registration
    def register(self, spec: CounterSpec,
                 probe: Optional[Callable[[], Any]] = None) -> None:
        """Declare one counter.  Registration happens once, at owner
        construction, before any sampling — the stream's column layout
        is frozen by the first tick."""
        assert self.stream.n_samples == 0, "register before first sample"
        self.specs.append(spec)
        self._probes.append(probe)
        if probe is None:
            self._owned[spec.name] = 0.0 if spec.is_float else 0
        self.stream.specs = tuple(self.specs)

    def set_interval(self, interval: float) -> None:
        """Retarget the sampling interval — only before any samples
        exist (the boundary sequence k*I must be single-valued)."""
        assert self.stream.n_samples == 0, "set_interval before first sample"
        if interval <= 0:
            raise ValueError(f"counter interval must be > 0, got {interval}")
        self.interval = float(interval)

    def inc(self, name: str, by: Any = 1) -> None:
        """Bump an owned event counter (doorbells, tokens retired)."""
        self._owned[name] += by

    # ------------------------------------------------------------ sampling
    def _sample(self) -> Tuple:
        return tuple(
            (self._owned[s.name] if p is None else
             (float(p()) if s.is_float else int(p())))
            for s, p in zip(self.specs, self._probes))

    def tick(self, now: float) -> None:
        """Sample every interval boundary crossed up to ``now``."""
        b = self.interval * self._k
        if now < b or not _ENABLED:
            return
        vals = self._sample()
        # the last boundary interval * k <= now, found by the same
        # multiplication the boundaries are made of
        iv, k0 = self.interval, self._k
        k1 = max(k0, int(now // iv))
        while iv * (k1 + 1) <= now:
            k1 += 1
        while iv * k1 > now:
            k1 -= 1
        self.stream.extend([iv * k for k in range(k0, k1 + 1)], vals)
        self._k = k1 + 1

    # ------------------------------------------------------------- queries
    def value(self, name: str) -> Any:
        """Current (un-sampled) value of one counter."""
        for s, p in zip(self.specs, self._probes):
            if s.name == name:
                return (self._owned[name] if p is None else
                        (float(p()) if s.is_float else int(p())))
        raise KeyError(name)

    def totals(self) -> Dict[str, Any]:
        """Current value of every counter — the end-of-run summary the
        run-farm aggregates fleet-wide."""
        return {s.name: self.value(s.name) for s in self.specs}

    def functional_totals(self) -> Dict[str, Any]:
        return {s.name: self.value(s.name) for s in self.specs
                if s.scope == "functional"}

    def spec(self, name: str) -> CounterSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)

    # ------------------------------------------------- golden-corpus format
    def canonical(self) -> List[str]:
        """Header (bank identity + column declarations) followed by the
        sample stream — the committed ``tests/golden/*.counters`` unit."""
        head = [f"bank {self.name} interval={self.interval:.6f}",
                "columns " + " ".join(
                    f"{s.name}:{s.unit}:{s.scope}" for s in self.specs)]
        return head + self.stream.canonical()

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(f"{self.name}|{self.interval:.6f}|".encode())
        h.update(",".join(s.name for s in self.specs).encode())
        h.update(b"|")
        h.update(self.stream.digest().encode())
        return h.hexdigest()

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict[str, Any]:
        return {"owned": dict(self._owned), "k": self._k,
                "stream": self.stream.get_state()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._owned.update(state["owned"])
        self._k = state["k"]
        self.stream.set_state(state["stream"])


# --------------------------------------------------------------------------
# Shared bank constructors — one vocabulary for every link-backed channel, so
# the same counter names mean the same thing on a bridge DDR link, a
# fabric port and a switch hop (the Perfetto counter tracks and the fleet
# summaries merge by name).
# --------------------------------------------------------------------------

def register_link_counters(bank: CounterBank, link) -> None:
    """Counters probing an online ``LinkModel``: byte/stall/busy totals
    the arbiter already folds in grant order (core/congestion.py), so a
    probe is a dict-sum, never a timeline walk.  The per-engine folds
    are summed in sorted-engine order — the bit-exact twin of the
    profiler's ``EngineStats.grant_stall`` fold (tests/test_counters.py
    ::test_counter_closure_against_profiler)."""
    bank.register(CounterSpec("bytes_moved", "bytes"),
                  lambda: link.counter_bytes())
    bank.register(CounterSpec("busy_cycles", "cycles"),
                  lambda: link.counter_busy())
    bank.register(CounterSpec("stall_cycles", "cycles"),
                  lambda: link.counter_stall())
    bank.register(CounterSpec("dos_cycles", "cycles"),
                  lambda: link.counter_dos())
    bank.register(CounterSpec("cycles", "cycles"), lambda: link.now)


def register_switch_port_counters(bank: CounterBank, port) -> None:
    """Credit flow-control counters on one switch port (core/switch.py):
    grants/waits are plain ints the port already counts, credit_stall is
    its exact float accumulator."""
    register_link_counters(bank, port.link)
    bank.register(CounterSpec("credit_grants", "events"),
                  lambda: port.credit_grants)
    bank.register(CounterSpec("credit_waits", "events"),
                  lambda: port.credit_waits)
    bank.register(CounterSpec("credit_stall_cycles", "cycles"),
                  lambda: port.credit_stall)


# --------------------------------------------------------------------------
# Multi-bank helpers — the counter-diff oracle's unit of comparison is a
# target's ordered bank list, mirroring replay.target_logs.
# --------------------------------------------------------------------------

def counter_banks(target) -> List[CounterBank]:
    """Every counter bank a co-verification target owns, in a stable
    order (the owner defines it via ``counter_banks()``).  Mirrors
    ``replay.target_logs`` dispatch; targets predating the counter layer
    simply contribute no banks."""
    fn = getattr(target, "counter_banks", None)
    if callable(fn):
        return list(fn())
    bank = getattr(target, "counters", None)
    return [bank] if isinstance(bank, CounterBank) else []


def merged_digest(banks: Iterable[CounterBank]) -> str:
    """One digest over an ordered bank list — the full-stream side of
    the counter-diff oracle (backend-invariant at fixed scale)."""
    h = hashlib.sha256()
    for b in banks:
        h.update(b.digest().encode())
        h.update(b"\n")
    return h.hexdigest()


def merged_totals(banks: Iterable[CounterBank]) -> Dict[str, Any]:
    """ALL counter totals summed by name across banks — the per-unit
    counter summary the run farm merges fleet-wide (uid order, like
    coverage) and the sweep scheduler attaches to every cell."""
    out: Dict[str, Any] = {}
    for b in banks:
        for name, v in b.totals().items():
            out[name] = out.get(name, 0) + v
    return out


def functional_totals(banks: Iterable[CounterBank]) -> Dict[str, Any]:
    """Functional-scope counter totals summed by name across banks —
    every engine's tokens land in one ``tokens_retired`` total, which is
    what makes the result invariant across 1/2/4 devices."""
    out: Dict[str, Any] = {}
    for b in banks:
        for name, v in b.functional_totals().items():
            out[name] = out.get(name, 0) + v
    return out


def functional_digest(banks: Iterable[CounterBank]) -> str:
    """Digest of the functional totals — the cross-scale side of the
    counter-diff oracle."""
    h = hashlib.sha256()
    for name, v in sorted(functional_totals(banks).items()):
        h.update(f"{name}={v}\n".encode())
    return h.hexdigest()


@dataclasses.dataclass
class CounterDiff:
    """First divergence between two counter streams, plus the number of
    scalar comparisons spent finding it — the economics the planted-bug
    test pins against full trace diffing."""
    bank: str
    sample: int                 # row index of first divergence (-1: length)
    counter: str                # column name ("" for structural diffs)
    a: Any
    b: Any
    comparisons: int

    def render(self) -> str:
        return (f"counter divergence: bank={self.bank} sample={self.sample} "
                f"counter={self.counter} a={self.a!r} b={self.b!r} "
                f"({self.comparisons} comparisons)")


def diff_streams(banks_a: Iterable[CounterBank],
                 banks_b: Iterable[CounterBank]
                 ) -> Tuple[Optional[CounterDiff], int]:
    """Locate the first divergent sample between two bank lists.

    Returns ``(diff, comparisons)`` where ``diff`` is None when the
    streams are identical.  Comparisons are counted per scalar value so
    the oracle's cost is measurable against a full trace-line diff.
    """
    comparisons = 0
    la, lb = list(banks_a), list(banks_b)
    for a, b in zip(la, lb):
        comparisons += 1
        if a.name != b.name:
            return CounterDiff(a.name, -1, "", a.name, b.name,
                               comparisons), comparisons
        names = [s.name for s in a.specs]
        for i, (ta, ra) in enumerate(zip(a.stream.times, a.stream.rows)):
            if i >= b.stream.n_samples:
                break
            tb, rb = b.stream.times[i], b.stream.rows[i]
            comparisons += 1
            if ta != tb:
                return CounterDiff(a.name, i, "time", ta, tb,
                                   comparisons), comparisons
            for name, va, vb in zip(names, ra, rb):
                comparisons += 1
                if va != vb:
                    return CounterDiff(a.name, i, name, va, vb,
                                       comparisons), comparisons
        comparisons += 1
        if a.stream.n_samples != b.stream.n_samples:
            return CounterDiff(a.name, min(a.stream.n_samples,
                                           b.stream.n_samples), "",
                               a.stream.n_samples, b.stream.n_samples,
                               comparisons), comparisons
    comparisons += 1
    if len(la) != len(lb):
        return CounterDiff("", -1, "", len(la), len(lb),
                           comparisons), comparisons
    return None, comparisons
