"""Integrity-checked artifact directories (format v2): a per-file SHA-256
manifest and a terminal COMMIT marker, the same layout the JAX package
writes, so a model saved by either package loads in the other.

    <dir>/meta.json  arrays.npz  vocab.txt   payload
    <dir>/MANIFEST.json                      sha256 per payload file
    <dir>/COMMIT                             written last, via tmp+rename

A reader sees one of four states: committed (COMMIT present, hashes
verify), legacy (no MANIFEST, complete payload, or an MLlib-format dir
holding ``metadata/part-00000``), uncommitted (a crash mid-save; never
loaded), missing.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, Optional

from . import faultinject
from .errors import CorruptArtifactError

__all__ = [
    "COMMIT_NAME",
    "CorruptArtifactError",
    "MANIFEST_NAME",
    "artifact_ref",
    "artifact_status",
    "atomic_write_text",
    "file_sha256",
    "finalize_artifact_dir",
    "verify_artifact",
]

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"
LEGACY_PAYLOAD = ("meta.json", "arrays.npz", "vocab.txt")


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def atomic_write_text(path: str, text: str) -> None:
    """tmp + fsync + rename: the file exists complete or not at all."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def finalize_artifact_dir(
    path: str, files: Optional[Iterable[str]] = None
) -> Dict[str, str]:
    """Seal an artifact dir: manifest (per-file sha256), then COMMIT."""
    names = sorted(
        files
        if files is not None
        else (
            n for n in os.listdir(path)
            if os.path.isfile(os.path.join(path, n))
            and n not in (MANIFEST_NAME, COMMIT_NAME)
        )
    )
    hashes = {n: file_sha256(os.path.join(path, n)) for n in names}
    atomic_write_text(
        os.path.join(path, MANIFEST_NAME),
        json.dumps({"version": 2, "files": hashes}, indent=2, sort_keys=True),
    )
    faultinject.check("artifact.commit")
    atomic_write_text(os.path.join(path, COMMIT_NAME), "committed\n")
    return hashes


def artifact_ref(path: str) -> Dict[str, str]:
    """The epoch ledger's reference to a sealed artifact dir: the dir and
    the SHA-256 of its manifest (which pins every payload hash); a legacy
    dir gets no digest."""
    ref = {"path": path}
    manifest = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(manifest):
        ref["manifest_sha256"] = file_sha256(manifest)
    return ref


def artifact_status(path: str) -> str:
    """'committed' | 'legacy' | 'uncommitted' | 'missing'."""
    if not os.path.isdir(path):
        return "missing"
    has_manifest = os.path.exists(os.path.join(path, MANIFEST_NAME))
    has_commit = os.path.exists(os.path.join(path, COMMIT_NAME))
    if has_manifest and has_commit:
        return "committed"
    if has_manifest or has_commit:
        return "uncommitted"
    # an MLlib-format dir (metadata/part-00000) counts as legacy too: its
    # reader validates it
    if os.path.exists(os.path.join(path, "metadata", "part-00000")):
        return "legacy"
    missing = [
        n for n in LEGACY_PAYLOAD if not os.path.exists(os.path.join(path, n))
    ]
    return "uncommitted" if missing else "legacy"


def verify_artifact(path: str) -> str:
    """Raise ``CorruptArtifactError`` unless the dir is loadable; returns
    'committed' (every manifest hash re-verified) or 'legacy'."""
    status = artifact_status(path)
    if status == "missing":
        raise CorruptArtifactError(path, "no such artifact directory")
    if status == "uncommitted":
        raise CorruptArtifactError(
            path, "artifact is uncommitted (no COMMIT marker, or files missing)"
        )
    if status == "committed":
        with open(os.path.join(path, MANIFEST_NAME), encoding="utf-8") as f:
            try:
                manifest = json.load(f)
            except json.JSONDecodeError as exc:
                raise CorruptArtifactError(
                    path, f"unreadable manifest: {exc}"
                ) from exc
        for name, want in sorted(manifest.get("files", {}).items()):
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                raise CorruptArtifactError(
                    path, f"manifest file {name!r} is missing"
                )
            got = file_sha256(fp)
            if got != want:
                raise CorruptArtifactError(
                    path, f"checksum mismatch for {name!r}"
                )
    return status
