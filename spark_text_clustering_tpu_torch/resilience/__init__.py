"""Resilience layer of the port: artifact integrity (manifest + COMMIT,
format v2), typed failures, the resume gate, retry with backoff, seeded
fault injection, the dead-letter quarantine, the epoch commit ledger of
exactly-once streaming resume, and the supervised worker fleet (fence
tokens, heartbeat leases, the SIGTERM drain notice, the supervisor): the
JAX package's names, for what the port has."""

from . import faultinject  # noqa: F401
from .errors import (  # noqa: F401
    CorruptArtifactError,
    FencedEpochError,
    ResilienceError,
    ResumeMismatchError,
)
from .integrity import (  # noqa: F401
    COMMIT_NAME,
    MANIFEST_NAME,
    artifact_ref,
    artifact_status,
    atomic_write_text,
    file_sha256,
    finalize_artifact_dir,
    verify_artifact,
)
from .ledger import (  # noqa: F401
    LEDGER_NAME,
    EpochLedger,
    RecoveryReport,
    record_checksum,
    shard_filename,
    shard_span,
    validate_shard_plan,
)
from .quarantine import QUARANTINED_COUNTER, Quarantine, requeue  # noqa: F401
from .resume import (  # noqa: F401
    RESUME_META_NAME,
    config_hash,
    validate_resume_meta,
    vocab_fingerprint,
    write_resume_meta,
)
from .retry import (  # noqa: F401
    IO_POLICY,
    TELEMETRY_POLICY,
    RetryGiveUp,
    RetryPolicy,
    backoff_delays,
    configure_lease_deadline,
    retry_call,
    sleep,
)
from .supervisor import (  # noqa: F401
    FleetFence,
    FleetLedger,
    FleetReport,
    FleetSupervisor,
    PreemptionNotice,
    WorkerLease,
    fleet_committed_sources,
    lease_path,
    partition_of,
    worker_dir,
)
