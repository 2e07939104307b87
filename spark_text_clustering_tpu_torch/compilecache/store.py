"""Content-addressed on-disk store of the port's kernel libraries (the
JAX package's executable store, with a ``.so`` for a payload).

Layout — one sealed entry dir per library::

    <root>/<toolchain-fingerprint>/<digest>/
        entry.json          label (the source's name: estep, ...),
                            signature (the digest of every source under
                            csrc/ and the flags), fingerprint, the
                            original build seconds
        <label>.so          the library nvcc built
        MANIFEST.json       per-file sha256 (resilience.integrity)
        COMMIT              terminal marker — last thing written
    <root>/<toolchain-fingerprint>/.quarantine/<digest>.<n>/
                            entries that failed verify/load, kept for
                            triage (never re-read)

The fingerprint (``ops._build.toolchain_fingerprint``) binds an entry to
everything that can make a library wrong for this process: the nvcc
release, the ``-gencode`` target, the flags and the host's machine.
``digest`` is sha1(label|signature)[:10], so a process B lookup hits
exactly when process A built the same source set with the same flags
under the same toolchain.  Writes use the artifact layer's
publish-then-commit discipline: the whole entry is staged in a
``.stage-*`` sibling, sealed there (manifest + COMMIT), and atomically
renamed into place — concurrent workers race safely (the loser's rename
fails on the existing dir and it discards its stage), and a crash
mid-write leaves a visibly uncommitted stage the GC sweeps.

Reads are paranoid by contract: anything less than a committed dir with
verifying checksums, a matching (label, signature, fingerprint) triple,
and a payload the loader accepts is a MISS — counted
(``compile.cache_misses``, plus ``compile.cache_invalidations`` when a
previously committed entry had to be quarantined), never a crash, and
never a wrong library.  The ``compilecache.read`` /
``compilecache.write`` fault sites make that contract chaos-testable.

Metrics go straight to the always-live registry (the counters must move
even in registry-only processes, e.g. a supervised worker without a run
stream); run-stream events (``compile_cache``) ride the normal facade
and only land when a writer is configured.  Imports neither torch nor
jax.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..resilience import faultinject
from ..resilience.errors import CorruptArtifactError
from ..resilience.integrity import (
    COMMIT_NAME,
    artifact_status,
    finalize_artifact_dir,
    verify_artifact,
)

__all__ = ["CachedLibrary", "ExecutableStore", "ENTRY_SCHEMA"]

ENTRY_SCHEMA = 1
ENTRY_JSON = "entry.json"
QUARANTINE_DIR = ".quarantine"
STAGE_PREFIX = ".stage-"


def payload_name(label: str) -> str:
    """The payload file of an entry: the library, named by its source."""
    return f"{label}.so"


@dataclass
class CachedLibrary:
    """One committed library, loaded from the store."""

    digest: str
    label: str
    path: str                     # the payload inside the entry dir
    library: Any                  # what the loader made of it
    load_seconds: float
    meta: Dict[str, Any]


def _counter(name: str):
    from .. import telemetry

    return telemetry.get_registry().counter(name)


def _gauge(name: str):
    from .. import telemetry

    return telemetry.get_registry().gauge(name)


def _event(**fields) -> None:
    from .. import telemetry

    telemetry.event("compile_cache", **fields)


class ExecutableStore:
    """The content-addressed store rooted at one directory."""

    def __init__(self, root: str) -> None:
        self.root = root
        self._fingerprint: Optional[str] = None
        self._quarantine_seq = 0

    # -- keys ------------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        """Toolchain fingerprint, computed once per process (it asks
        ``nvcc --version``; raises ``KernelError`` without nvcc)."""
        if self._fingerprint is None:
            from ..ops import _build

            self._fingerprint = _build.toolchain_fingerprint()
        return self._fingerprint

    def entry_dir(self, digest: str, fingerprint: Optional[str] = None):
        return os.path.join(
            self.root, fingerprint or self.fingerprint, digest
        )

    def contains(self, digest: str) -> bool:
        """Whether a committed entry sits at ``digest`` (no verification,
        no counting: ``warm`` asks it to plan its builds)."""
        try:
            return os.path.exists(
                os.path.join(self.entry_dir(digest), COMMIT_NAME))
        except Exception as exc:
            del exc
            return False

    # -- read side -------------------------------------------------------
    def lookup(
        self,
        label: str,
        signature: str,
        digest: str,
        load: Optional[Callable[[str], Any]] = None,
    ) -> Optional[CachedLibrary]:
        """Load ``digest`` if a committed, verifying, fingerprint-matched
        entry exists (``load(payload path)`` makes the library; without
        it the path is the library); count the hit/miss; NEVER raise."""
        try:
            return self._lookup(label, signature, digest, load)
        except Exception as exc:
            # the read path must be unkillable: an unexpected failure
            # (no nvcc, full disk, permission flip mid-run) is a counted
            # miss
            _counter("compile.cache_misses").inc()
            _event(
                op="miss", digest=digest, label=label,
                reason=f"error:{type(exc).__name__}",
            )
            return None

    def _lookup(self, label, signature, digest, load):
        path = self.entry_dir(digest)
        t0 = time.perf_counter()
        try:
            faultinject.check("compilecache.read")
            status = artifact_status(path)
            if status == "missing":
                self._miss(digest, label, "absent")
                return None
            if status != "committed":
                # a torn publish (crash mid-stage cannot produce this,
                # but a crash mid-quarantine or manual tampering can)
                raise CorruptArtifactError(path, f"status {status}")
            verify_artifact(path)
            with open(
                os.path.join(path, ENTRY_JSON), encoding="utf-8"
            ) as f:
                meta = json.load(f)
            if (
                meta.get("label") != label
                or meta.get("signature") != signature
                or meta.get("fingerprint") != self.fingerprint
            ):
                # digest collision, truncated hash, or a stale
                # fingerprint written under an older key scheme
                raise CorruptArtifactError(
                    path, "entry metadata does not match the requested "
                    "(label, signature, fingerprint) triple"
                )
        except OSError as exc:
            # transient I/O (or an injected one): a miss, not an
            # invalidation — the entry may be fine on the next process
            self._miss(digest, label, f"ioerror:{type(exc).__name__}")
            return None
        except CorruptArtifactError as exc:
            self._invalidate(path, digest, label, str(exc))
            return None
        except Exception as exc:
            self._invalidate(
                path, digest, label, f"{type(exc).__name__}: {exc}"
            )
            return None
        payload = os.path.join(path, payload_name(label))
        try:
            library = load(payload) if load is not None else payload
        except Exception as exc:
            # a payload the loader refuses (not a library, a missing
            # symbol): the entry is poison for every future reader —
            # quarantine it
            self._invalidate(
                path, digest, label, f"{type(exc).__name__}: {exc}"
            )
            return None
        dt = time.perf_counter() - t0
        entry = CachedLibrary(
            digest=digest,
            label=label,
            path=payload,
            library=library,
            load_seconds=dt,
            meta=meta,
        )
        _counter("compile.cache_hits").inc()
        _gauge(f"compile.{digest}.cache_load_seconds").set(round(dt, 6))
        _event(
            op="hit", digest=digest, label=label,
            load_seconds=round(dt, 6),
            compile_seconds_saved=meta.get("compile_seconds"),
        )
        return entry

    def _miss(self, digest: str, label: str, reason: str) -> None:
        _counter("compile.cache_misses").inc()
        _event(op="miss", digest=digest, label=label, reason=reason)

    def _invalidate(
        self, path: str, digest: str, label: str, reason: str
    ) -> None:
        """Quarantine a corrupt/stale entry so the next reader pays one
        cheap missing-dir miss instead of re-verifying garbage."""
        _counter("compile.cache_invalidations").inc()
        qdir = os.path.join(os.path.dirname(path), QUARANTINE_DIR)
        moved = None
        try:
            os.makedirs(qdir, exist_ok=True)
            while True:
                self._quarantine_seq += 1
                moved = os.path.join(
                    qdir, f"{digest}.{self._quarantine_seq}"
                )
                if not os.path.exists(moved):
                    break
            os.rename(path, moved)
        except OSError:
            moved = None          # best effort; the miss still counts
        self._miss(digest, label, "invalidated")
        _event(
            op="invalidate", digest=digest, label=label,
            reason=reason[:300], quarantined=moved,
        )

    # -- write side ------------------------------------------------------
    def store(
        self,
        label: str,
        signature: str,
        digest: str,
        payload_path: str,
        compile_seconds: Optional[float] = None,
    ) -> bool:
        """Publish the library at ``payload_path``; True when this process
        committed the entry (False: already present, lost the publish
        race, or write failure — all non-fatal)."""
        try:
            return self._store(
                label, signature, digest, payload_path, compile_seconds
            )
        except Exception as exc:
            _event(
                op="store_failed", digest=digest, label=label,
                reason=f"{type(exc).__name__}: {exc}"[:300],
            )
            return False

    def _store(
        self, label, signature, digest, payload_path, compile_seconds
    ) -> bool:
        final = self.entry_dir(digest)
        if os.path.exists(os.path.join(final, COMMIT_NAME)):
            return False          # someone already published this digest
        stage = os.path.join(
            os.path.dirname(final),
            f"{STAGE_PREFIX}{digest}-{os.getpid()}",
        )
        staged = os.path.join(stage, payload_name(label))
        try:
            faultinject.check("compilecache.write")
            os.makedirs(stage, exist_ok=True)
            shutil.copyfile(payload_path, staged)
            faultinject.corrupt("compilecache.write", staged)
            size = os.path.getsize(staged)
            meta = {
                "schema": ENTRY_SCHEMA,
                "label": label,
                "signature": signature,
                "digest": digest,
                "fingerprint": self.fingerprint,
                "compile_seconds": (
                    None if compile_seconds is None
                    else round(float(compile_seconds), 6)
                ),
                "payload_bytes": size,
                "created_at": time.time(),
            }
            with open(
                os.path.join(stage, ENTRY_JSON), "w", encoding="utf-8"
            ) as f:
                json.dump(meta, f, indent=2, sort_keys=True)
                f.write("\n")
            # seal INSIDE the stage, then one atomic rename publishes:
            # a reader can never observe a committed-but-partial entry
            finalize_artifact_dir(stage)
            os.rename(stage, final)
        except OSError:
            # lost the publish race (ENOTEMPTY/EEXIST) or an injected
            # ioerror: discard our stage, the cache stays consistent
            shutil.rmtree(stage, ignore_errors=True)
            if os.path.exists(os.path.join(final, COMMIT_NAME)):
                return False      # raced: the other writer's entry won
            _event(op="store_failed", digest=digest, label=label,
                   reason="ioerror")
            return False
        _counter("compile.cache_stores").inc()
        _event(
            op="store", digest=digest, label=label,
            payload_bytes=size,
            compile_seconds=compile_seconds,
        )
        return True

    # -- maintenance (the `compile-cache` verb) --------------------------
    def _fingerprint_dirs(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            os.path.join(self.root, n) for n in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, n))
            and not n.startswith(".")
        )

    def entries(self) -> List[Dict[str, Any]]:
        """Every entry across every fingerprint, with its status —
        committed entries carry their metadata, anything else is listed
        with status only (``ls``/``verify`` render this)."""
        out: List[Dict[str, Any]] = []
        for fdir in self._fingerprint_dirs():
            fp = os.path.basename(fdir)
            for name in sorted(os.listdir(fdir)):
                path = os.path.join(fdir, name)
                if not os.path.isdir(path) or name.startswith("."):
                    continue
                rec: Dict[str, Any] = {
                    "fingerprint": fp,
                    "digest": name,
                    "path": path,
                    "status": artifact_status(path),
                    "stale": fp != self._safe_fingerprint(),
                }
                try:
                    with open(
                        os.path.join(path, ENTRY_JSON), encoding="utf-8"
                    ) as f:
                        meta = json.load(f)
                    rec.update({
                        "label": meta.get("label"),
                        "signature": str(meta.get("signature", ""))[:120],
                        "payload_bytes": meta.get("payload_bytes"),
                        "compile_seconds": meta.get("compile_seconds"),
                        "created_at": meta.get("created_at"),
                    })
                except (OSError, json.JSONDecodeError) as exc:
                    rec["error"] = f"{type(exc).__name__}: {exc}"
                out.append(rec)
        return out

    def _safe_fingerprint(self) -> Optional[str]:
        """The live fingerprint, or None when nvcc is unavailable (the
        maintenance verbs must work without a toolchain)."""
        try:
            return self.fingerprint
        except Exception as exc:
            del exc
            return None

    def verify(self) -> List[Dict[str, Any]]:
        """Re-hash every committed entry; returns one finding per entry
        that would NOT load (report-only: the read path quarantines on
        first contact, `verify` just says so ahead of time)."""
        findings: List[Dict[str, Any]] = []
        for rec in self.entries():
            if rec["status"] != "committed":
                findings.append({
                    **rec, "finding": f"status {rec['status']}",
                })
                continue
            try:
                verify_artifact(rec["path"])
            except CorruptArtifactError as exc:
                findings.append({**rec, "finding": str(exc)})
        return findings

    def gc(self, keep_newest: int) -> Dict[str, int]:
        """Prune to the ``keep_newest`` most recent committed entries
        per fingerprint; drop every uncommitted stage, quarantined
        entry, and anything unreadable.  Returns removal counts."""
        removed = {"entries": 0, "stages": 0, "quarantined": 0}
        for fdir in self._fingerprint_dirs():
            qdir = os.path.join(fdir, QUARANTINE_DIR)
            if os.path.isdir(qdir):
                removed["quarantined"] += len(os.listdir(qdir))
                shutil.rmtree(qdir, ignore_errors=True)
            aged: List[Any] = []
            for name in sorted(os.listdir(fdir)):
                path = os.path.join(fdir, name)
                if not os.path.isdir(path):
                    continue
                if name.startswith(STAGE_PREFIX):
                    shutil.rmtree(path, ignore_errors=True)
                    removed["stages"] += 1
                    continue
                if name.startswith("."):
                    continue
                if artifact_status(path) != "committed":
                    shutil.rmtree(path, ignore_errors=True)
                    removed["entries"] += 1
                    continue
                try:
                    with open(
                        os.path.join(path, ENTRY_JSON), encoding="utf-8"
                    ) as f:
                        created = float(
                            json.load(f).get("created_at") or 0.0
                        )
                except (OSError, json.JSONDecodeError, ValueError):
                    created = 0.0
                aged.append((created, path))
            aged.sort(reverse=True)
            for _, path in aged[max(0, keep_newest):]:
                shutil.rmtree(path, ignore_errors=True)
                removed["entries"] += 1
        return removed
