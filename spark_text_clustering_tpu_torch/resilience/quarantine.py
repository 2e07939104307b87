"""Dead-letter quarantine for per-document streaming failures, copied from
the JAX package: a malformed document must not kill a long-running
stream, so the streaming scorer and trainer route it here (its text and a
structured ``.error.json`` sidecar) and keep going.  ``requeue`` replays
the payloads into a watch directory once the fault is fixed.

Layout::

    <dir>/q-<seq>-<safe name>.txt          the document text
    <dir>/q-<seq>-<safe name>.error.json   {name, stage, error, batch_id}
    <dir>/.archive/                        sidecars retired by ``requeue``
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

from .integrity import atomic_write_text

__all__ = ["ARCHIVE_DIRNAME", "QUARANTINED_COUNTER", "Quarantine", "requeue"]

# the JAX package's counters of quarantined, replayed and archived docs
QUARANTINED_COUNTER = "resilience.quarantined"
REPLAYED_COUNTER = "requeue.replayed"
ARCHIVED_COUNTER = "requeue.archived"
ARCHIVE_DIRNAME = ".archive"

_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


class Quarantine:
    """Append-only dead-letter dir.  ``Quarantine(None)`` keeps only the
    count (``count``), so call sites always hold a usable handle."""

    def __init__(self, directory: Optional[str]) -> None:
        self.directory = directory
        self.count = 0

    def put(
        self,
        name: str,
        text: str,
        error: BaseException,
        *,
        stage: str,
        batch_id: Optional[int] = None,
    ) -> Optional[str]:
        """Quarantine one document; returns the payload path (None without
        a directory).  Never raises: a failing quarantine disk must not
        take the stream down with it."""
        from .. import telemetry

        self.count += 1
        telemetry.count(QUARANTINED_COUNTER)
        telemetry.event(
            "quarantine",
            doc=name, stage=stage, error=repr(error),
            **({} if batch_id is None else {"batch_id": batch_id}),
        )
        if not self.directory:
            return None
        safe = _SAFE.sub("_", os.path.basename(name))[:80] or "doc"
        stem = os.path.join(self.directory, f"q-{self.count:06d}-{safe}")
        try:
            os.makedirs(self.directory, exist_ok=True)
            atomic_write_text(stem + ".txt", text)
            atomic_write_text(
                stem + ".error.json",
                json.dumps(
                    {
                        "name": name,
                        "stage": stage,
                        "error": repr(error),
                        "batch_id": batch_id,
                    },
                    indent=2,
                ),
            )
        except OSError:
            return None
        return stem + ".txt"


def requeue(
    quarantine_dir: str,
    watch_dir: str,
    *,
    dry_run: bool = False,
) -> Dict[str, List[str]]:
    """Move every ``q-*.txt`` payload of ``quarantine_dir`` into
    ``watch_dir`` (the stream picks it up as a new file) and its
    ``.error.json`` sidecar to ``<quarantine_dir>/.archive/``;
    ``dry_run`` lists what would move.  Returns ``{"replayed": [...],
    "archived": [...], "skipped": [...]}`` (skipped: moves that failed;
    they stay quarantined)."""
    from .. import telemetry

    out: Dict[str, List[str]] = {"replayed": [], "archived": [], "skipped": []}
    try:
        names = sorted(os.listdir(quarantine_dir))
    except OSError:
        return out
    payloads = [n for n in names if n.startswith("q-") and n.endswith(".txt")]
    archive = os.path.join(quarantine_dir, ARCHIVE_DIRNAME)
    for n in payloads:
        src = os.path.join(quarantine_dir, n)
        dest = os.path.join(watch_dir, n)
        sidecar = n[: -len(".txt")] + ".error.json"
        side_src = os.path.join(quarantine_dir, sidecar)
        if dry_run:
            out["replayed"].append(dest)
            if os.path.exists(side_src):
                out["archived"].append(os.path.join(archive, sidecar))
            continue
        try:
            os.makedirs(watch_dir, exist_ok=True)
            shutil.move(src, dest)
        except OSError:
            out["skipped"].append(src)
            continue
        out["replayed"].append(dest)
        telemetry.count(REPLAYED_COUNTER)
        if os.path.exists(side_src):
            try:
                os.makedirs(archive, exist_ok=True)
                shutil.move(side_src, os.path.join(archive, sidecar))
                out["archived"].append(os.path.join(archive, sidecar))
                telemetry.count(ARCHIVED_COUNTER)
            except OSError:
                out["skipped"].append(side_src)
        telemetry.event("requeue", doc=n, watch_dir=watch_dir)
    return out
