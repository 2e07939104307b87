"""Declarative registry of the fleet's shared-file protocol surface, a
copy of the JAX package's ``analysis/protocol_sites.py`` whose entries
name the port's modules and qualnames.

The coordination fabric is threads plus files: lease files discover
replicas, the epoch ledger fences writers, per-replica control files
drive rolling swaps, the actions file closes the monitor->supervisor
loop, ``front.json`` announces the router, and the compile cache
publishes executables by directory rename.  Before those protocols
leave a single box (multi-host), every touchpoint must be
provably torn-read tolerant and atomically published.

This module is the registry the protocol audit
(``analysis/protocol_audit.py``, STC300-305) checks BOTH directions,
in the style of ``faultinject.SITES``:

* code -> registry: a write or read of a protocol path outside a
  registered writer/reader is a finding (STC302/STC303);
* registry -> code: a registered site that no longer resolves, or that
  lost its atomic-publish / tolerance / fsync shape, is a finding too
  (stale registry entries must not rot into false confidence).

Paths are recognised syntactically: a string literal in
``PATH_LITERALS``, a constant name in ``PATH_CONSTANTS``, a call to a
helper in ``PATH_HELPERS``, or a ``self.<attr>`` registered in
``PATH_ATTRS`` — plus one level of local-variable assignment from any
of those.  Keep the vocabulary in lockstep with the code it names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Tuple

from .ast_rules import PACKAGE

__all__ = [
    "WriterSite",
    "ReaderSite",
    "SchemaPair",
    "ProtocolSites",
    "SITES",
]

_P = PACKAGE


@dataclass(frozen=True)
class WriterSite:
    """One sanctioned write route to a protocol path.

    ``kind`` is the publish discipline the audit enforces:
    ``"atomic"`` must stage then ``os.replace``/``os.rename`` (or call
    ``atomic_write_text``, which is that dance); ``"append"`` must
    open the path in append mode.  ``durable=True`` adds STC304: the
    writer must ``os.fsync`` before its record is considered published
    (ledger appends, the alert log).
    """

    module: str
    qualname: str
    kind: str = "atomic"            # "atomic" | "append"
    durable: bool = False


@dataclass(frozen=True)
class ReaderSite:
    """One sanctioned read route.  The audit requires the function to
    contain a ``try``/``except`` that survives a torn or missing file
    (STC303) — readers of shared files must treat mid-write as
    'not there yet', never as a crash."""

    module: str
    qualname: str


@dataclass(frozen=True)
class SchemaPair:
    """A writer/reader schema contract checked by STC305.

    The emitted field set is extracted statically from the writers'
    dict literals, from keyword arguments at every call site of
    ``field_call_names`` (the lease's ``beat(queue_depth=..., ...)``
    forwarding funnel), and from dict-literal values of keywords named
    in ``field_dict_kwargs`` (``lease_fields={"role": "serve"}``).
    ``extra_fields`` declares fields injected dynamically (trace
    context).  The required set is every key a reader subscripts or
    ``.get``s WITHOUT a default off a value seeded by
    ``reader_seed_calls`` — a required-but-never-emitted field is
    schema drift caught at lint time instead of in a cross-host
    incident.
    """

    name: str
    writers: Tuple[Tuple[str, str], ...]
    readers: Tuple[Tuple[str, str], ...]
    reader_seed_calls: Tuple[str, ...]
    field_call_names: Tuple[str, ...] = ()
    field_dict_kwargs: Tuple[str, ...] = ()
    exclude_fields: Tuple[str, ...] = ()
    extra_fields: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ProtocolSites:
    """The full protocol surface one audit run checks."""

    threaded_modules: Tuple[str, ...]
    path_literals: FrozenSet[str]
    path_constants: FrozenSet[str]
    path_helpers: FrozenSet[str]
    path_attrs: FrozenSet[Tuple[str, str, str]]   # (module, class, attr)
    atomic_snapshots: Dict[Tuple[str, str, str], str] = field(
        default_factory=dict
    )
    writers: Tuple[WriterSite, ...] = ()
    readers: Tuple[ReaderSite, ...] = ()
    schema_pairs: Tuple[SchemaPair, ...] = ()

    def site_count(self) -> int:
        """Registry size for the ``lint.protocol_sites`` counter."""
        return (
            len(self.writers) + len(self.readers)
            + len(self.path_attrs) + len(self.schema_pairs)
            + len(self.atomic_snapshots)
        )

    def watched_modules(self) -> FrozenSet[str]:
        """Every module the registry names — the ``--changed`` gate:
        the protocol tier runs iff one of these changed."""
        mods = set(self.threaded_modules)
        mods.update(w.module for w in self.writers)
        mods.update(r.module for r in self.readers)
        mods.update(m for m, _c, _a in self.path_attrs)
        mods.update(m for m, _c, _a in self.atomic_snapshots)
        for p in self.schema_pairs:
            mods.update(m for m, _q in p.writers)
            mods.update(m for m, _q in p.readers)
        return frozenset(mods)


SITES = ProtocolSites(
    # Modules whose classes share state across threads: the STC300
    # lock graph and the STC301 thread-escape rule walk exactly these.
    threaded_modules=(
        f"{_P}/serving/coalescer.py",
        f"{_P}/serving/server.py",
        f"{_P}/serving/front.py",
        f"{_P}/telemetry/alerts.py",
        f"{_P}/telemetry/transport.py",
        f"{_P}/resilience/supervisor.py",
    ),
    # Inline filename literals that mean "a protocol path".
    path_literals=frozenset({
        "front.json",               # router announce (serving/front.py)
        "fleet.jsonl",              # fence ledger (resilience/supervisor.py)
        "epochs.jsonl",             # epoch ledger (resilience/ledger.py)
        "alerts.jsonl",             # alert-state log (telemetry/alerts.py)
    }),
    # Module-level constants that hold protocol path components.
    path_constants=frozenset({
        "LEASE_DIRNAME",            # supervisor: leases/<worker>.json
        "CONTROL_DIRNAME",          # supervisor: control/<worker>.json
        "FLEET_LOG_NAME",           # supervisor: fleet.jsonl
        "LEDGER_NAME",              # ledger: epochs.jsonl
        "ALERTS_LOG_NAME",          # alerts: alerts.jsonl
        "ENTRY_JSON",               # compilecache: entry.json
        "PAYLOAD_BIN",              # compilecache: executable.bin
        "TREES_PKL",                # compilecache: trees.pkl
        "SPOOL_NAME",               # transport: ship-spool.jsonl
        "COLLECT_ANNOUNCE_NAME",    # transport: collect.json
    }),
    # Functions whose return value IS a protocol path.
    path_helpers=frozenset({
        "worker_dir", "lease_path", "control_path",       # supervisor
        "_intent_path", "_marker_path",                   # ledger
        "_ack_path",                                      # supervisor
        "entry_dir",                                      # compilecache
        "source_stream_path",                             # transport
    }),
    # self.<attr> slots that hold a protocol path.
    path_attrs=frozenset({
        (f"{_P}/resilience/supervisor.py", "FleetLedger", "path"),
        (f"{_P}/resilience/supervisor.py", "WorkerLease", "path"),
        (f"{_P}/resilience/supervisor.py", "FleetSupervisor",
         "actions_file"),
        (f"{_P}/resilience/ledger.py", "EpochLedger", "path"),
        (f"{_P}/telemetry/alerts.py", "JsonlTailer", "path"),
        (f"{_P}/telemetry/alerts.py", "AlertLog", "path"),
        (f"{_P}/telemetry/alerts.py", "ActionEmitter", "path"),
        (f"{_P}/telemetry/transport.py", "ShipSpool", "path"),
    }),
    # Lock-free cross-thread reads STC301 accepts: the attribute is
    # only ever rebound to a fully-constructed immutable object, never
    # mutated in place — readers snapshot it once per operation.
    atomic_snapshots={
        (f"{_P}/serving/server.py", "ScoringService", "_scorer"):
            "hot swap publishes a fully-warmed ServeScorer by single "
            "rebind under _swap_lock; _dispatch snapshots it once per "
            "batch (same contract the STC007 baseline waiver records)",
    },
    writers=(
        WriterSite(f"{_P}/resilience/supervisor.py",
                   "WorkerLease._write"),
        WriterSite(f"{_P}/resilience/supervisor.py",
                   "ServeFleetSupervisor._issue_swap"),
        # actions ack: <actions_file>.ack, atomic so a torn ack can
        # never replay an action
        WriterSite(f"{_P}/resilience/supervisor.py",
                   "FleetSupervisor._check_actions"),
        WriterSite(f"{_P}/resilience/supervisor.py",
                   "FleetLedger.append", kind="append", durable=True),
        WriterSite(f"{_P}/resilience/ledger.py", "EpochLedger.begin"),
        WriterSite(f"{_P}/resilience/ledger.py", "EpochLedger.commit",
                   kind="append", durable=True),
        WriterSite(f"{_P}/resilience/ledger.py", "EpochLedger.compact"),
        # recover() truncates a torn trailing append by atomic rewrite
        WriterSite(f"{_P}/resilience/ledger.py", "EpochLedger.recover"),
        WriterSite(f"{_P}/resilience/ledger.py",
                   "EpochLedger.stage_shard"),
        WriterSite(f"{_P}/telemetry/alerts.py", "AlertLog.append",
                   kind="append", durable=True),
        WriterSite(f"{_P}/telemetry/alerts.py", "ActionEmitter.flush"),
        WriterSite(f"{_P}/serving/front.py", "write_front_announce"),
        # telemetry transport plane: the spool append IS the
        # durability contract — a batch counts as spooled only after its
        # fsync'd checksummed line lands, exactly like a ledger commit
        WriterSite(f"{_P}/telemetry/transport.py", "ShipSpool.append",
                   kind="append", durable=True),
        WriterSite(f"{_P}/telemetry/transport.py", "ShipSpool.compact"),
        # the collector's batch fold: event lines + ONE collect_batch
        # marker, fsync'd BEFORE the ack (marker-last = commit point)
        WriterSite(f"{_P}/telemetry/transport.py", "Collector.ingest",
                   kind="append", durable=True),
        # restart recovery truncates an un-markered tail atomically
        WriterSite(f"{_P}/telemetry/transport.py",
                   "Collector._recover_stream"),
        WriterSite(f"{_P}/telemetry/transport.py",
                   "write_collect_announce"),
        # compile cache: stage dir then one os.rename publishes the
        # whole artifact (entry.json + payload + trees)
        WriterSite(f"{_P}/compilecache/store.py",
                   "ExecutableStore._store"),
    ),
    readers=(
        ReaderSite(f"{_P}/resilience/supervisor.py", "read_lease"),
        ReaderSite(f"{_P}/resilience/supervisor.py", "read_control"),
        ReaderSite(f"{_P}/resilience/supervisor.py",
                   "FleetLedger.records"),
        ReaderSite(f"{_P}/resilience/supervisor.py",
                   "FleetSupervisor._read_action_ack"),
        ReaderSite(f"{_P}/resilience/supervisor.py",
                   "FleetSupervisor._check_actions"),
        ReaderSite(f"{_P}/resilience/ledger.py",
                   "EpochLedger._read_lines"),
        ReaderSite(f"{_P}/resilience/ledger.py",
                   "EpochLedger._rollback"),
        ReaderSite(f"{_P}/resilience/ledger.py",
                   "EpochLedger.await_shards"),
        ReaderSite(f"{_P}/telemetry/alerts.py", "JsonlTailer.poll"),
        ReaderSite(f"{_P}/telemetry/alerts.py", "AlertLog.replay"),
        ReaderSite(f"{_P}/telemetry/alerts.py", "read_actions"),
        ReaderSite(f"{_P}/serving/probe.py", "read_front_announce"),
        ReaderSite(f"{_P}/telemetry/transport.py", "ShipSpool.load"),
        ReaderSite(f"{_P}/telemetry/transport.py",
                   "Collector._recover_stream"),
        ReaderSite(f"{_P}/telemetry/transport.py",
                   "read_collect_announce"),
        ReaderSite(f"{_P}/compilecache/store.py",
                   "ExecutableStore._lookup"),
        ReaderSite(f"{_P}/compilecache/store.py",
                   "ExecutableStore.entries"),
        ReaderSite(f"{_P}/compilecache/store.py", "ExecutableStore.gc"),
    ),
    schema_pairs=(
        # supervisor <-> front: every lease field the front's replica
        # discovery (and the monitor's lease pseudo-events, and the
        # supervisor's own sweep) requires must be emitted by the
        # WorkerLease funnel.
        SchemaPair(
            name="lease",
            writers=(
                (f"{_P}/resilience/supervisor.py", "WorkerLease._write"),
            ),
            readers=(
                (f"{_P}/serving/front.py", "read_replicas"),
                (f"{_P}/telemetry/alerts.py",
                 "AlertEngine._lease_events"),
                (f"{_P}/resilience/supervisor.py",
                 "FleetSupervisor._sweep"),
                (f"{_P}/resilience/supervisor.py",
                 "ServeFleetSupervisor._advance_roll"),
                (f"{_P}/resilience/supervisor.py",
                 "ServeFleetSupervisor._spawn_deferred_if_ready"),
            ),
            reader_seed_calls=("read_lease",),
            field_call_names=("beat", "mark_done", "_write"),
            field_dict_kwargs=("lease_fields", "static_fields"),
            # beat(force=True) is consumed by beat itself, not emitted
            exclude_fields=("force",),
            # stamped via **tracing.fields() in WorkerLease._write
            extra_fields=(
                "trace_id", "span_id", "parent_span_id", "sampled",
            ),
        ),
        # supervisor <-> replica: the rolling-swap control file.
        SchemaPair(
            name="control",
            writers=(
                (f"{_P}/resilience/supervisor.py",
                 "ServeFleetSupervisor._issue_swap"),
            ),
            readers=(
                (f"{_P}/cli.py", "_serve_replica_loop"),
            ),
            reader_seed_calls=("read_control",),
        ),
        # shipper <-> collector: the HTTP batch envelope.  The shipper
        # emits it as one dict literal in _ship; the collector's fold
        # subscripts it off _decode_envelope — a field the fold starts
        # requiring that the shipper never sends is caught here, not in
        # a cross-host 400 storm.
        SchemaPair(
            name="ship_envelope",
            writers=(
                (f"{_P}/telemetry/transport.py", "EventShipper._ship"),
            ),
            readers=(
                (f"{_P}/telemetry/transport.py", "Collector.ingest"),
            ),
            reader_seed_calls=("_decode_envelope",),
        ),
    ),
)
