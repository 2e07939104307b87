"""Auto-resume compatibility gate (``train --resume``, ``stream-train
--resume``), copied from the JAX package: the same meta file, hash and
fingerprint, so a checkpoint dir that either package's CLI wrote passes
the other's gate.

A checkpoint is only a valid resume point for a run that is training the
SAME model: same structural hyperparameters and the same vocabulary.
The CLI records a ``resume_meta.json`` next to the checkpoint (config
hash over the structure-determining ``Params`` fields + the vocabulary
fingerprint) and ``--resume`` validates it before touching the saved
state — a mismatch raises ``ResumeMismatchError`` instead of silently
continuing from misaligned state.

``max_iterations`` and other run-length/observability knobs are
EXCLUDED from the hash: resuming "the same training, further" is the
whole point of ``--resume``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from .errors import ResumeMismatchError
from .integrity import atomic_write_text

__all__ = [
    "RESUME_META_NAME",
    "config_hash",
    "vocab_fingerprint",
    "write_resume_meta",
    "validate_resume_meta",
]

RESUME_META_NAME = "resume_meta.json"


def vocab_fingerprint(vocab) -> int:
    """Stable 32-bit fingerprint of a vocabulary, persisted with
    checkpoints: a resumed run whose vocab merely has the same SIZE
    would otherwise silently map term columns to different terms."""
    import zlib

    h = 0
    for t in vocab:
        h = zlib.crc32(t.encode("utf-8"), h)
    return h

# Params fields that may differ between the original run and its resume
# without changing WHAT is being trained (run length, I/O paths, purely
# observational switches).
_NON_STRUCTURAL = frozenset({
    "input",
    "max_iterations",
    "checkpoint_dir",
    "checkpoint_interval",
    "record_iteration_times",
    "keep_doc_topic_counts",
    "dispatch_budget_bytes",
})


def config_hash(params) -> str:
    """Stable hash of the structure-determining ``Params`` fields."""
    cfg = json.loads(params.to_json())
    reduced = {
        k: v for k, v in cfg.items() if k not in _NON_STRUCTURAL
    }
    return hashlib.sha256(
        json.dumps(reduced, sort_keys=True).encode("utf-8")
    ).hexdigest()[:16]


def write_resume_meta(
    checkpoint_dir: str,
    params,
    vocab_fp: Optional[int] = None,
    **extra,
) -> str:
    """Record this run's compatibility envelope next to its checkpoints
    (atomic; overwrites any previous meta — the latest run owns the
    dir)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, RESUME_META_NAME)
    atomic_write_text(
        path,
        json.dumps(
            {
                "config_hash": config_hash(params),
                "vocab_fp": vocab_fp,
                "algorithm": params.algorithm,
                "k": params.k,
                **extra,
            },
            indent=2,
            sort_keys=True,
        ),
    )
    return path


def validate_resume_meta(
    checkpoint_dir: str,
    params,
    vocab_fp: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Optional[dict]:
    """Check a checkpoint dir's recorded envelope against this run.

    Returns the recorded meta (None when the dir has no meta — nothing
    to validate against, e.g. pre-resilience checkpoints).  Raises
    ``ResumeMismatchError`` on a config-hash or vocab-fingerprint
    mismatch.

    ``process_count`` (where the caller passes one) gates elastic
    resume: a restart with another process count than the one recorded
    is valid only where the dir carries an epoch commit ledger, whose
    records pin each process's state shard to its vocabulary columns.
    """
    path = os.path.join(checkpoint_dir, RESUME_META_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise ResumeMismatchError(
            checkpoint_dir, f"unreadable {RESUME_META_NAME}: {exc}"
        ) from exc
    want = config_hash(params)
    got = meta.get("config_hash")
    if got != want:
        raise ResumeMismatchError(
            checkpoint_dir,
            f"checkpoint was written by config {got} but this run is "
            f"{want} (k/alpha/eta/seed/sampling/... differ) — use the "
            "original flags or a fresh --checkpoint-dir",
        )
    if (
        vocab_fp is not None
        and meta.get("vocab_fp") is not None
        and int(meta["vocab_fp"]) != int(vocab_fp)
    ):
        raise ResumeMismatchError(
            checkpoint_dir,
            "checkpoint was trained with a different vocabulary "
            "(fingerprint mismatch) — term columns would misalign",
        )
    if (
        process_count is not None
        and meta.get("process_count") is not None
        and int(meta["process_count"]) != int(process_count)
        and not meta.get("ledger")
    ):
        raise ResumeMismatchError(
            checkpoint_dir,
            f"checkpoint was written by {meta['process_count']} "
            f"process(es) but this run has {process_count}, and the dir "
            f"has no epoch commit ledger — elastic resume needs "
            f"ledger-pinned state shards (re-run the original topology "
            f"or start fresh)",
        )
    return meta
