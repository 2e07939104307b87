"""Transactional epoch commit ledger: exactly-once streaming resume,
copied from the JAX package (the same files, records and checksums, so a
stream checkpoint dir either package wrote resumes in the other).

ONE append-only, per-record-checksummed ledger that both training state
and emitted outputs (reports, published models) hang off.  Layout (inside
a stream checkpoint dir)::

    <dir>/epochs.jsonl                      one committed epoch per line
    <dir>/epoch-000007.intent.json          staged-but-uncommitted epoch
    <dir>/stream_state-e000007-p0.npz       per-process state shard
                                            (tmp+rename+sidecar,
                                            persistence.save_train_state)
    <dir>/epoch-000007.ready-p1.json        worker shard ready marker
    <dir>/quarantined_epochs/epoch-000007/  rolled-back orphan payloads

Two-phase protocol per trigger epoch: ``begin()`` writes the intent (the
consumed source paths and the payload files about to be written)
atomically, the payloads are made durable, then ``commit()`` digests
them and appends ONE checksummed, fsync'd line (the commit point) and
removes the intent.  ``recover()`` truncates a torn final line and moves
the payloads of every uncommitted intent to ``quarantined_epochs/``;
committed epochs are never recomputed (their sources seed the stream
source's seen-set).

Several processes: the coordinator owns the append; workers stage their
vocabulary-column state shards (``stage_shard``) and publish ready
markers, the coordinator waits for them (``await_shards``) and the
workers for the commit (``await_committed``).  ``shard_span`` is
deterministic, so a restart with another process count re-slices the
merged state.

Fault-injection sites: ``ledger.stage`` (before the intent write) and
``ledger.commit`` (before the append); the payload writes have
``ckpt.write`` and ``report.write``.  Intents, committed records and
ready markers carry the process's causal trace context (each committed
record a child span of it), and commits, rollbacks and compactions count
in ``ledger.commits`` / ``.rollbacks`` / ``.compactions`` with an event
each, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .. import telemetry
from ..telemetry import tracing
from . import faultinject
from .errors import CorruptArtifactError, ResilienceError
from .integrity import atomic_write_text, file_sha256
from .retry import retry_call
from .retry import sleep as _sleep

__all__ = [
    "LEDGER_NAME",
    "QUARANTINE_DIRNAME",
    "LEDGER_SCHEMA",
    "SNAPSHOT_KIND",
    "EpochLedger",
    "RecoveryReport",
    "record_checksum",
    "shard_span",
    "shard_filename",
    "validate_shard_plan",
]

LEDGER_NAME = "epochs.jsonl"
QUARANTINE_DIRNAME = "quarantined_epochs"
LEDGER_SCHEMA = 1
SNAPSHOT_KIND = "snapshot"


def record_checksum(record: Dict) -> str:
    """SHA256 over the canonical (sorted, compact) JSON of ``record``
    WITHOUT its ``checksum`` field — per-line integrity so a torn append
    (the crash window of the commit point itself) is detectable."""
    body = {k: v for k, v in record.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(
            body, sort_keys=True, separators=(",", ":")
        ).encode("utf-8")
    ).hexdigest()


COMMITS_COUNTER = "ledger.commits"
ROLLBACKS_COUNTER = "ledger.rollbacks"
COMPACTIONS_COUNTER = "ledger.compactions"


def shard_span(v_pad: int, process_index: int, process_count: int) -> Tuple[int, int]:
    """Column span ``[lo, hi)`` of the vocab axis owned by one process's
    checkpoint shard.  Deterministic in (v_pad, index, count) so any
    LATER process count can re-derive — and re-slice — the layout
    (elastic resume)."""
    if not (0 <= process_index < process_count):
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})"
        )
    chunk = -(-v_pad // process_count)          # ceil div
    lo = min(v_pad, process_index * chunk)
    hi = min(v_pad, lo + chunk)
    return lo, hi


def shard_filename(epoch: int, process_index: int) -> str:
    return f"stream_state-e{epoch:06d}-p{process_index}.npz"


def validate_shard_plan(record: Dict, v_pad: int) -> List[Dict]:
    """Check a committed record's shard list partitions ``[0, v_pad)``
    exactly (no gap, no overlap) — the elastic-resume precondition.
    Returns the shards ordered by column span; raises
    ``CorruptArtifactError`` on a malformed plan."""
    shards = sorted(
        record.get("shards", []), key=lambda s: tuple(s["cols"])
    )
    at = 0
    for s in shards:
        lo, hi = s["cols"]
        if lo != at or hi < lo:
            raise CorruptArtifactError(
                record.get("dir", "<ledger>"),
                f"epoch {record.get('epoch')} shard plan is torn: "
                f"expected columns to resume at {at}, got [{lo}, {hi})",
            )
        at = hi
    if at != v_pad:
        raise CorruptArtifactError(
            record.get("dir", "<ledger>"),
            f"epoch {record.get('epoch')} shard plan covers {at} of "
            f"{v_pad} vocab columns",
        )
    return shards


@dataclass
class RecoveryReport:
    """What ``recover()`` found and did."""

    last_epoch: int = -1                 # newest committed epoch (-1: none)
    rolled_back: List[int] = field(default_factory=list)
    truncated_lines: int = 0             # torn trailing ledger appends
    quarantined: List[str] = field(default_factory=list)


class EpochLedger:
    """Append-only, checksummed epoch commit ledger over one directory.

    All reads re-parse the (small) ledger file so concurrent processes
    sharing the directory — the multi-host staging protocol — always see
    the latest committed state.
    """

    def __init__(self, directory: str, *, fence=None) -> None:
        # ``fence``: any object with a ``verify()`` raising
        # ``FencedEpochError`` when this writer's fleet token has been
        # superseded (resilience.supervisor.FleetFence).  Checked before
        # every mutating phase — a zombie worker from a pre-resize
        # generation gets its staged shards refused typed instead of
        # corrupting the new topology's shard plan.
        self.directory = directory
        self.fence = fence
        self.path = os.path.join(directory, LEDGER_NAME)

    def _check_fence(self) -> None:
        if self.fence is not None:
            self.fence.verify()

    # -- reading ---------------------------------------------------------
    def _read_lines(self) -> Tuple[List[Dict], int]:
        """(valid records, torn-tail line count).  A checksum-invalid or
        unparseable line is tolerated ONLY as the final line (a torn
        commit append); anywhere else the ledger is corrupt."""
        if not os.path.exists(self.path):
            return [], 0
        with open(self.path, "r", encoding="utf-8") as f:
            raw = f.read().split("\n")
        lines = [ln for ln in raw if ln.strip()]
        records: List[Dict] = []
        for i, ln in enumerate(lines):
            bad = None
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError as exc:
                bad = f"unparseable line: {exc}"
                rec = None
            if rec is not None and record_checksum(rec) != rec.get("checksum"):
                bad = "record checksum mismatch"
            if bad is not None:
                if i == len(lines) - 1:
                    return records, 1       # torn tail: roll back
                raise CorruptArtifactError(
                    self.path, f"ledger line {i + 1}: {bad} (not the "
                    f"final line — the ledger suffix cannot be trusted)",
                )
            records.append(rec)
        return records, 0

    def records(self) -> List[Dict]:
        """Committed records (a torn tail line is ignored here; only
        ``recover()`` rewrites the file)."""
        return self._read_lines()[0]

    def last_committed(self) -> int:
        recs = self.records()
        return max((r["epoch"] for r in recs), default=-1)

    def next_epoch(self) -> int:
        return self.last_committed() + 1

    def record_for(self, epoch: int) -> Optional[Dict]:
        for r in self.records():
            if r["epoch"] == epoch:
                return r
        return None

    def committed_sources(self) -> Set[str]:
        out: Set[str] = set()
        for r in self.records():
            out.update(r.get("sources", ()))
        return out

    # -- two-phase write -------------------------------------------------
    def _intent_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch-{epoch:06d}.intent.json")

    def _marker_path(self, epoch: int, process_index: int) -> str:
        return os.path.join(
            self.directory, f"epoch-{epoch:06d}.ready-p{process_index}.json"
        )

    def begin(
        self,
        epoch: int,
        *,
        kind: str,
        sources: Iterable[str],
        payloads: Iterable[str],
        process_count: int = 1,
    ) -> str:
        """Phase 1 (stage): durably record the INTENT — which payload
        files are about to be written for this epoch — so a crash before
        commit leaves enough to roll the orphans back."""
        if epoch != self.next_epoch():
            raise ValueError(
                f"epoch {epoch} out of order (next is {self.next_epoch()})"
            )
        intent = {
            "schema": LEDGER_SCHEMA,
            "epoch": epoch,
            "kind": kind,
            "sources": sorted(sources),
            "payloads": sorted(payloads),
            "process_count": int(process_count),
        }
        # the staged intent carries the process span (the committed record
        # carries its own child span), so a crash between stage and commit
        # still leaves an attributable orphan
        ctx = tracing.current()
        if ctx is not None:
            intent["trace"] = ctx.to_fields()
        path = self._intent_path(epoch)

        def _write() -> None:
            self._check_fence()
            faultinject.check("ledger.stage")
            os.makedirs(self.directory, exist_ok=True)
            atomic_write_text(
                path, json.dumps(intent, indent=2, sort_keys=True) + "\n"
            )

        retry_call(_write, site="ledger.stage")
        return path

    def commit(
        self,
        epoch: int,
        *,
        kind: str,
        sources: Iterable[str],
        payloads: Optional[Dict[str, str]] = None,
        shards: Optional[List[Dict]] = None,
        model_ref: Optional[object] = None,
        process_count: int = 1,
        **extra,
    ) -> Dict:
        """Phase 2 (commit): digest every payload, append ONE checksummed
        record, then clear the intent.  The fsync'd append is the commit
        point — everything before it rolls back on crash, everything
        after it is exactly-once durable."""
        payloads = payloads or {}
        digests = {}
        for name, p in sorted(payloads.items()):
            if not os.path.exists(p):
                raise CorruptArtifactError(
                    p, f"epoch {epoch} payload {name!r} vanished before "
                    f"commit",
                )
            digests[name] = {
                "path": self._relpath(p),
                "sha256": file_sha256(p),
            }
        record = {
            "schema": LEDGER_SCHEMA,
            "epoch": epoch,
            "kind": kind,
            "sources": sorted(sources),
            "payloads": digests,
            "process_count": int(process_count),
            "ts": time.time(),
            **({"shards": shards} if shards else {}),
            **({"model_ref": model_ref} if model_ref else {}),
            **extra,
        }
        # every committed record owns one span, a child of the process
        # context, so an epoch hangs off the worker that produced it
        ctx = tracing.current()
        span_fields = None
        if ctx is not None:
            span_fields = ctx.child().to_fields()
            record["trace"] = span_fields
        if self.fence is not None:
            # worker identity rides the record too: lineage resolves
            # "which worker/generation/spawn committed this epoch"
            # without re-deriving it from the fleet ledger
            for key, attr in (
                ("worker", "worker_index"),
                ("generation", "generation"),
                ("spawn_id", "spawn_id"),
            ):
                val = getattr(self.fence, attr, None)
                if val is not None and key not in record:
                    record[key] = int(val)
        record["checksum"] = record_checksum(record)
        line = json.dumps(record, sort_keys=True) + "\n"

        def _append() -> None:
            # the fence check sits INSIDE the commit critical section:
            # as close to the append as a filesystem protocol allows, so
            # a resize that lands between a zombie's begin() and its
            # commit() still refuses the stale epoch
            self._check_fence()
            faultinject.check("ledger.commit")
            os.makedirs(self.directory, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

        retry_call(_append, site="ledger.commit")
        telemetry.count(COMMITS_COUNTER)
        telemetry.event(
            "ledger_commit", epoch=epoch, kind=kind,
            sources=len(record["sources"]), payloads=len(digests),
            **(span_fields or {}),
        )
        # post-commit cleanup: best-effort — a crash in THIS window
        # leaves a stale intent for a committed epoch, which recover()
        # simply deletes (no rollback)
        try:
            os.unlink(self._intent_path(epoch))
        except OSError:
            pass
        for p in self._stale_markers(epoch):
            try:
                os.unlink(p)
            except OSError:
                pass
        self._gc_shards()
        return record

    def _relpath(self, p: str) -> str:
        """Store ledger-dir-relative paths when the payload lives inside
        the dir (the common shard case) so the dir is relocatable."""
        ap, ad = os.path.abspath(p), os.path.abspath(self.directory)
        if ap.startswith(ad + os.sep):
            return os.path.relpath(ap, ad)
        return ap

    def resolve(self, stored: str) -> str:
        if os.path.isabs(stored):
            return stored
        return os.path.join(self.directory, stored)

    def _stale_markers(self, epoch: int) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        stem = f"epoch-{epoch:06d}.ready-p"
        return [
            os.path.join(self.directory, n)
            for n in names if n.startswith(stem)
        ]

    def _gc_shards(self) -> None:
        """Delete state shards NOT referenced by the newest committed
        record that carries shards — only the latest shard set is a
        resume point, and shard-less epochs (``model-publish``) must not
        orphan it.  Keyed on the referenced FILENAMES (not record
        epochs) because a compacted snapshot record keeps its original
        shard files under an older epoch number.  Reports and other
        payloads outside the ledger dir are never touched — they ARE
        the exactly-once output."""
        newest = None
        for r in self.records():
            if r.get("shards"):
                newest = r
        if newest is None:
            return
        keep = {s["file"] for s in newest["shards"]}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for n in names:
            if not (n.startswith("stream_state-e") and ".npz" in n):
                continue
            base = n[: -len(".sha256")] if n.endswith(".sha256") else n
            if base not in keep:
                try:
                    os.unlink(os.path.join(self.directory, n))
                except OSError:
                    pass

    # -- recovery --------------------------------------------------------
    def recover(self) -> RecoveryReport:
        """Roll the directory forward to a consistent exactly-once state:
        truncate a torn trailing append, quarantine every staged-but-
        uncommitted epoch's orphan payloads, clear stale intents/markers
        of committed epochs.  Idempotent; run before resuming a stream."""
        report = RecoveryReport()
        records, torn = self._read_lines()
        report.last_epoch = max((r["epoch"] for r in records), default=-1)
        if torn:
            # rewrite the ledger with only the valid prefix (atomic)
            report.truncated_lines = torn
            atomic_write_text(
                self.path,
                "".join(
                    json.dumps(r, sort_keys=True) + "\n" for r in records
                ),
            )
            telemetry.count(ROLLBACKS_COUNTER)
            telemetry.event(
                "ledger_rollback", reason="torn_append",
                last_epoch=report.last_epoch,
            )
        committed = {r["epoch"] for r in records}
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return report
        for n in names:
            if not (n.startswith("epoch-") and n.endswith(".intent.json")):
                continue
            try:
                epoch = int(n.split("-")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            ipath = os.path.join(self.directory, n)
            if epoch in committed:
                # post-commit crash window: the append landed but the
                # intent cleanup didn't — nothing to roll back
                try:
                    os.unlink(ipath)
                except OSError:
                    pass
                continue
            self._rollback(epoch, ipath, report)
        # orphan shards/markers with no intent AND no committed record
        # (a crash between payload write and... impossible under the
        # protocol, but a defensive sweep keeps the dir explicable).
        # "committed" is judged by referenced shard FILENAMES as well as
        # epoch numbers: a compacted snapshot record owns shard files
        # named for an older epoch.
        referenced = {
            s["file"] for r in records for s in r.get("shards", ())
        }
        for n in sorted(os.listdir(self.directory)):
            if n.startswith("stream_state-e"):
                try:
                    e = int(n[len("stream_state-e"):].split("-", 1)[0])
                except ValueError:
                    continue
                base = n[: -len(".sha256")] if n.endswith(".sha256") else n
                if e not in committed and base not in referenced:
                    self._quarantine_file(
                        e, os.path.join(self.directory, n), report
                    )
        return report

    def _rollback(self, epoch: int, intent_path: str, report: RecoveryReport) -> None:
        try:
            with open(intent_path, encoding="utf-8") as f:
                intent = json.load(f)
        except (OSError, json.JSONDecodeError):
            intent = {"payloads": []}
        for stored in intent.get("payloads", []):
            p = self.resolve(stored)
            if os.path.exists(p):
                self._quarantine_file(epoch, p, report)
            sidecar = p + ".sha256"
            if os.path.exists(sidecar):
                self._quarantine_file(epoch, sidecar, report)
        for m in self._stale_markers(epoch):
            try:
                os.unlink(m)
            except OSError:
                pass
        try:
            os.unlink(intent_path)
        except OSError:
            pass
        report.rolled_back.append(epoch)
        telemetry.count(ROLLBACKS_COUNTER)
        telemetry.event(
            "ledger_rollback", reason="uncommitted_epoch", epoch=epoch,
        )

    def _quarantine_file(self, epoch: int, path: str, report: RecoveryReport) -> None:
        qdir = os.path.join(
            self.directory, QUARANTINE_DIRNAME, f"epoch-{epoch:06d}"
        )
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, os.path.basename(path))
            shutil.move(path, dest)
        except OSError:
            return
        report.quarantined.append(dest)

    # -- compaction ------------------------------------------------------
    def compact(self) -> Optional[Dict]:
        """Fold the committed history into ONE checksummed snapshot
        record (kind ``snapshot``) — resume stays O(1) on long-lived
        streams instead of re-parsing one line per trigger epoch.

        The snapshot preserves everything resume reads: the union of
        committed source paths (the exactly-once seen-set), the newest
        epoch number (``next_epoch`` keeps counting from there), and the
        newest shard-bearing record's shard plan + training counters
        (``step``/``docs_seen``/``batches_seen``), still pointing at the
        SAME shard files on disk.  Per-epoch payload digests of already-
        emitted reports are dropped — the reports themselves are the
        durable output; only their sources matter for replay
        suppression.  Run ``recover()`` first: compaction refuses to run
        over an open transaction (a staged intent).

        Returns the snapshot record, or None when there is nothing to
        fold (fewer than two committed records).
        """
        records, torn = self._read_lines()
        if torn:
            raise CorruptArtifactError(
                self.path,
                "torn trailing append — run recover() before compacting",
            )
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            names = []
        intents = [n for n in names if n.endswith(".intent.json")]
        if intents:
            raise ResilienceError(
                f"{self.path}: staged intent(s) outstanding "
                f"({', '.join(sorted(intents))}) — compaction only runs "
                f"between committed epochs; recover() first"
            )
        if len(records) < 2:
            return None
        sources: Set[str] = set()
        for r in records:
            sources.update(r.get("sources", ()))
        newest = records[-1]
        shard_rec = None
        for r in records:
            if r.get("shards"):
                shard_rec = r
        model_rec = None
        for r in records:
            if r.get("model_ref"):
                model_rec = r
        snapshot = {
            "schema": LEDGER_SCHEMA,
            "epoch": max(r["epoch"] for r in records),
            "kind": SNAPSHOT_KIND,
            "sources": sorted(sources),
            "compacted_epochs": len(records),
            "process_count": int(
                (shard_rec or newest).get("process_count", 1)
            ),
        }
        if shard_rec is not None:
            for k in ("shards", "step", "docs_seen", "batches_seen"):
                if k in shard_rec:
                    snapshot[k] = shard_rec[k]
        if model_rec is not None:
            snapshot["model_ref"] = model_rec["model_ref"]
        snapshot["checksum"] = record_checksum(snapshot)
        atomic_write_text(
            self.path, json.dumps(snapshot, sort_keys=True) + "\n"
        )
        telemetry.count(COMPACTIONS_COUNTER)
        telemetry.event(
            "ledger_compact",
            epoch=snapshot["epoch"],
            compacted=len(records),
            sources=len(snapshot["sources"]),
        )
        return snapshot

    # -- multi-host staging rendezvous ----------------------------------
    def stage_shard(
        self,
        epoch: int,
        process_index: int,
        process_count: int,
        *,
        cols: Tuple[int, int],
        step: int,
        **arrays,
    ) -> Dict:
        """Worker side: durably write this process's state shard for
        ``epoch`` (atomic npz + checksum sidecar via the persistence
        layer), then publish a ready marker carrying its digest.
        Returns the shard spec the commit record will embed."""
        from ..models.persistence import save_train_state

        self._check_fence()
        fname = shard_filename(epoch, process_index)
        path = os.path.join(self.directory, fname)
        os.makedirs(self.directory, exist_ok=True)
        save_train_state(path, step, **arrays)
        spec = {
            "p": int(process_index),
            "of": int(process_count),
            "file": fname,
            "cols": [int(cols[0]), int(cols[1])],
            "sha256": file_sha256(path),
        }
        # the ready marker names the staging process's causal context
        ctx = tracing.current()
        if ctx is not None:
            spec["trace"] = ctx.to_fields()
        atomic_write_text(
            self._marker_path(epoch, process_index),
            json.dumps(spec, indent=2, sort_keys=True) + "\n",
        )
        return spec

    def await_shards(
        self,
        epoch: int,
        process_count: int,
        *,
        timeout_s: float = 60.0,
        poll_s: float = 0.05,
    ) -> List[Dict]:
        """Coordinator side: rendezvous on ``epoch`` — block until every
        process's ready marker is published, then return the shard specs
        (ordered by process index).  Raises ``ResilienceError`` on
        timeout: the epoch stays uncommitted and recover() rolls the
        staged shards back instead of committing a torn checkpoint."""
        deadline = time.monotonic() + timeout_s
        while True:
            specs = []
            for p in range(process_count):
                mp = self._marker_path(epoch, p)
                try:
                    with open(mp, encoding="utf-8") as f:
                        specs.append(json.load(f))
                except (OSError, json.JSONDecodeError):
                    break
            if len(specs) == process_count:
                return specs
            if time.monotonic() >= deadline:
                raise ResilienceError(
                    f"epoch {epoch}: only {len(specs)}/{process_count} "
                    f"shards staged within {timeout_s}s — torn multi-host "
                    f"checkpoint left uncommitted (will roll back)"
                )
            _sleep(poll_s)

    def await_committed(
        self,
        epoch: int,
        *,
        timeout_s: float = 60.0,
        poll_s: float = 0.05,
    ) -> Dict:
        """Worker side: block until the coordinator's append for
        ``epoch`` lands (the workers' rendezvous on the commit point)."""
        deadline = time.monotonic() + timeout_s
        while True:
            rec = self.record_for(epoch)
            if rec is not None:
                return rec
            if time.monotonic() >= deadline:
                raise ResilienceError(
                    f"epoch {epoch}: coordinator commit did not land "
                    f"within {timeout_s}s"
                )
            _sleep(poll_s)
