"""Paged KV-cache pool with admission control — the port of
``repro.serving.kvpool`` (value-free bookkeeping, copied as it is).

``ServingEngine`` in continuous-batching mode reserves a request's whole
worst-case KV footprint — padded prompt plus ``max_new_tokens - 1`` decode
entries — from a fixed page pool **at admission**.  A request whose
reservation cannot be satisfied is *deferred*: it stays at the head of the
FIFO pending queue and is retried on a later scheduler tick.  Pages return
to the free pool when the request retires (never mid-flight preemption).

The free list is a LIFO stack popped from a fixed initial order, so the
page ids a request holds are deterministic.  ``leak_every`` is a
fault-injection knob: every ``leak_every``-th release silently drops one
page (a late-firing paging bug).
"""
from __future__ import annotations

from typing import Dict, List


class KVPool:
    """Fixed pool of ``n_pages`` KV pages, ``page_size`` cache entries
    (token positions) each, with per-request page lists."""

    def __init__(self, n_pages: int, page_size: int = 16,
                 leak_every: int = 0) -> None:
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool geometry: {n_pages} pages x "
                             f"{page_size} entries")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.leak_every = int(leak_every)
        self.reset()

    def reset(self) -> None:
        """Fresh pool: all pages free, counters cleared."""
        # LIFO stack; popping from the end yields pages in 0,1,2,... order
        self.free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.pages: Dict[int, List[int]] = {}   # rid -> held page ids
        self.deferrals = 0      # admission attempts denied for lack of pages
        self.releases = 0
        self.leaked = 0
        self.peak_in_use = 0

    # -------------------------------------------------------------- policy
    def pages_for(self, n_entries: int) -> int:
        """Pages covering ``n_entries`` KV positions (ceil division)."""
        return -(-max(0, int(n_entries)) // self.page_size)

    def fits(self, n_entries: int) -> bool:
        """Whether ``n_entries`` could EVER be admitted (whole-pool bound —
        the doorbell-time rejection test for impossible requests)."""
        return self.pages_for(n_entries) <= self.n_pages

    def reserve(self, rid: int, n_entries: int) -> bool:
        """Reserve the full footprint for ``rid`` or defer: returns False
        (and counts a deferral) without partial allocation when the free
        list is short."""
        if rid in self.pages:
            raise ValueError(f"request {rid} already holds pages")
        need = self.pages_for(n_entries)
        if need > len(self.free):
            self.deferrals += 1
            return False
        self.pages[rid] = [self.free.pop() for _ in range(need)]
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return True

    def release(self, rid: int) -> None:
        """Return ``rid``'s pages (retire-time eviction).  With the
        ``leak_every`` bug knob armed, every ``leak_every``-th release
        drops its last page on the floor."""
        held = self.pages.pop(rid)
        self.releases += 1
        if self.leak_every and self.releases % self.leak_every == 0 \
                and held:
            held = held[:-1]
            self.leaked += 1
        # reverse-order push keeps the free list a true LIFO stack
        self.free.extend(reversed(held))

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self.free)

    def held_by(self, rid: int) -> List[int]:
        return list(self.pages.get(rid, ()))

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> dict:
        return {"free": list(self.free),
                "pages": {rid: list(p) for rid, p in self.pages.items()},
                "deferrals": self.deferrals,
                "releases": self.releases,
                "leaked": self.leaked,
                "peak_in_use": self.peak_in_use}

    def set_state(self, state: dict) -> None:
        self.free = list(state["free"])
        self.pages = {rid: list(p) for rid, p in state["pages"].items()}
        self.deferrals = state["deferrals"]
        self.releases = state["releases"]
        self.leaked = state["leaked"]
        self.peak_in_use = state["peak_in_use"]

    def __repr__(self) -> str:
        return (f"KVPool({self.in_use}/{self.n_pages} pages in use, "
                f"page_size={self.page_size}, "
                f"deferrals={self.deferrals})")
