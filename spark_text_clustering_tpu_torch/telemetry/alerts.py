"""Tail-following readers of live JSONL run streams (the JAX package's
``telemetry/alerts.py``, its tailing part copied).

``JsonlTailer`` reads one stream incrementally; ``StreamSet`` tails every
stream a set of glob patterns names, picking up streams that appear
mid-run.  The serve fleet's supervisor reads its replicas' streams with
them (the queueing estimate of ``supervise --role serve``).  Tailing is
torn-line and truncation tolerant: a partial trailing line waits for the
next poll, a rewritten or rotated file is read again from the top, and a
missing file is quiet.

The rest of the JAX module (the alert rules and their engine,
``ActionEmitter`` and ``firing_alerts``) comes with ROADMAP.md queue 1
item 9b.2; ``metrics tail`` reads with these tailers.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

__all__ = ["JsonlTailer", "StreamSet"]


class JsonlTailer:
    """Incremental reader of ONE JSONL stream.

    Only COMPLETE lines (newline-terminated) are consumed — a torn
    trailing line (a writer mid-append) stays buffered until its
    newline arrives, so a record is never half-parsed.  A file whose
    size shrank below the read offset was truncated or rotated: the
    tailer restarts from the top (the stream's writer truncates on
    ``configure``, so this is a new run, not data loss).  Unparseable
    complete lines are skipped, like ``read_events``.
    """

    def __init__(self, path: str, *, from_start: bool = True) -> None:
        self.path = path
        self.offset = 0
        self._buf = b""
        if not from_start:
            try:
                self.offset = os.path.getsize(path)
            except OSError:
                self.offset = 0

    def poll(self) -> List[Dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []                   # missing/unreadable: quiet
        if size < self.offset:
            # truncation/rotation: the retained offset points past the
            # new end — restart from the top and drop the stale buffer
            self.offset = 0
            self._buf = b""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        self.offset += len(chunk)
        data = self._buf + chunk
        lines = data.split(b"\n")
        self._buf = lines.pop()         # partial tail (or b"")
        out: List[Dict] = []
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out


class StreamSet:
    """Tail N streams named by glob patterns, re-expanded every poll so
    streams that appear mid-run (a respawned worker's
    ``events-p3.jsonl``) are picked up live.  Each event is tagged with
    its source stream under ``_stream`` (the skew rules' ``by`` key)."""

    def __init__(
        self, patterns: List[str], *, from_start: bool = True
    ) -> None:
        self.patterns = list(patterns)
        self.from_start = from_start
        self._tailers: Dict[str, JsonlTailer] = {}

    def paths(self) -> List[str]:
        out: List[str] = []
        for pat in self.patterns:
            out.extend(sorted(glob.glob(pat)))
            # a literal path that doesn't exist YET still gets a tailer
            # — it goes live the moment the writer creates it
            if not glob.has_magic(pat) and pat not in out:
                out.append(pat)
        seen, uniq = set(), []
        for p in out:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        return uniq

    def poll(self) -> List[Dict]:
        out: List[Dict] = []
        for p in self.paths():
            t = self._tailers.get(p)
            if t is None:
                t = JsonlTailer(p, from_start=self.from_start)
                self._tailers[p] = t
            label = os.path.basename(p)
            for e in t.poll():
                e["_stream"] = label
                out.append(e)
        return out

    def stream_count(self) -> int:
        return sum(
            1 for p in self.paths() if os.path.exists(p)
        )
