"""Resilience layer of the port: artifact integrity (manifest + COMMIT,
format v2), typed failures, and the resume gate of ``train --resume``."""

from .errors import (  # noqa: F401
    CorruptArtifactError,
    ResilienceError,
    ResumeMismatchError,
)
from .integrity import (  # noqa: F401
    COMMIT_NAME,
    MANIFEST_NAME,
    artifact_status,
    atomic_write_text,
    file_sha256,
    finalize_artifact_dir,
    verify_artifact,
)
from .resume import (  # noqa: F401
    RESUME_META_NAME,
    config_hash,
    validate_resume_meta,
    vocab_fingerprint,
    write_resume_meta,
)
