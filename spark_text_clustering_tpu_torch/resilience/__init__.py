"""Artifact integrity for the port (manifest + COMMIT, format v2)."""

from .integrity import (  # noqa: F401
    COMMIT_NAME,
    MANIFEST_NAME,
    CorruptArtifactError,
    artifact_status,
    atomic_write_text,
    file_sha256,
    finalize_artifact_dir,
    verify_artifact,
)
