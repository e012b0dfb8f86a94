"""Persistent, resumable campaign result store — one JSON line per
completed unit.

Single-writer by construction: only the MANAGER process appends (workers
ship results over a queue), so records are never interleaved.  Each
append is flushed and fsynced before the unit counts as done; a campaign
killed mid-append leaves at most one torn final line, which ``load``
tolerates (skips) — that unit simply re-runs on resume.

The record schema is ``UnitResult.record()`` (units.py): uid, kind, ok,
digest, sparse coverage counts, scenario count, failures, the unit's
``payload`` hash (spec-drift guard), worker id, and seconds.  ``seconds``
and ``worker`` are the only non-deterministic fields and are excluded
from every digest.

``final_digest`` hashes ``(uid, digest)`` pairs in uid order — the
campaign's determinism witness: same seed ⇒ same digest at any worker
count, with or without an intervening kill/resume.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional


class ResultStore:
    def __init__(self, path) -> None:
        self.path = Path(path)
        self._fh = None

    # ------------------------------------------------------------ reading
    def load(self) -> Dict[str, dict]:
        """All committed records, keyed by uid (latest wins).  Tolerates a
        torn final line from a killed campaign."""
        records: Dict[str, dict] = {}
        if not self.path.exists():
            return records
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                    # torn tail — unit re-runs
            if isinstance(rec, dict) and "uid" in rec and "digest" in rec:
                records[rec["uid"]] = rec
        return records

    # ------------------------------------------------------------ writing
    def append(self, rec: dict) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "ResultStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ digests
    @staticmethod
    def final_digest(records: Dict[str, dict],
                     uids: Optional[list] = None) -> str:
        """sha256 over uid-sorted ``(uid, digest)`` pairs.  ``uids``
        restricts to one campaign's unit set (a store may hold more, e.g.
        after a spec change)."""
        h = hashlib.sha256()
        for uid in sorted(uids if uids is not None else records):
            h.update(f"{uid}:{records[uid]['digest']}\n".encode())
        return h.hexdigest()
