"""Typed failures of the port's resilience layer: a damaged artifact, a
checkpoint dir written by an incompatible run and a ledger write under a
superseded fleet token, each naming its path (the JAX package's
taxonomy)."""

from __future__ import annotations

__all__ = [
    "CorruptArtifactError",
    "FencedEpochError",
    "ResilienceError",
    "ResumeMismatchError",
]


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


class FencedEpochError(ResilienceError):
    """A ledger write arrived under a SUPERSEDED fleet fence token: the
    writer is a worker of an older fleet generation, and its staged shards
    are refused, typed, instead of merged into the new topology's shard
    plan.  ``fleet_dir`` is the fleet ledger that fenced the write.  The
    stream verbs exit 3 on it."""

    def __init__(self, fleet_dir: str, reason: str) -> None:
        self.fleet_dir = fleet_dir
        super().__init__(
            f"fenced ledger write (fleet {fleet_dir!r}): {reason}"
        )
