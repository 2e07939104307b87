"""Typed failures of the port's resilience layer: a damaged artifact and a
checkpoint dir written by an incompatible run, each naming its path (the
JAX package's taxonomy, as far as the port uses it)."""

from __future__ import annotations

__all__ = ["CorruptArtifactError", "ResilienceError", "ResumeMismatchError"]


class ResilienceError(Exception):
    """Base class for every failure the resilience layer raises."""


class CorruptArtifactError(ResilienceError):
    """A model or checkpoint artifact is unreadable, truncated,
    uncommitted, or fails checksum verification; ``path`` names it."""

    def __init__(self, path: str, reason: str) -> None:
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt artifact {path!r}: {reason}")


class ResumeMismatchError(ResilienceError):
    """``--resume`` found a checkpoint written by an INCOMPATIBLE run
    (different config hash or vocabulary fingerprint) — continuing would
    silently train a different model on misaligned state."""

    def __init__(self, checkpoint_dir: str, reason: str) -> None:
        self.checkpoint_dir = checkpoint_dir
        super().__init__(
            f"cannot resume from {checkpoint_dir!r}: {reason}"
        )
