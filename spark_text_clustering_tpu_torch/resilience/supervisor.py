"""Elastic fleet supervisor: the lifecycle of a preemptible stream worker
fleet and of a serve fleet, copied from the JAX package (its
``resilience/supervisor.py``).

A supervisor owns the worker set: it spawns N ``stream-train`` or
``stream-score`` subprocesses, watches them through heartbeat lease
files, and changes the topology between committed epochs, so a fleet of
machines that come and go keeps every file processed exactly once.

Fleet layout (inside the supervisor's ``--fleet-dir``), the JAX
package's, so a fleet dir either package wrote resumes in the other::

    <fleet-dir>/
      fleet.jsonl          the fleet ledger: one checksummed record per
                           topology transition (spawn/respawn/resize);
                           its newest record is the fence
      leases/w000.json     per-worker heartbeat lease (atomic rewrite)
      w000/, w001/, ...    per-worker epoch-ledger checkpoint dirs

Every worker holds a fence token ``(generation, worker_index,
spawn_id)`` issued at spawn.  The fleet ledger's newest record maps each
live worker index to its current spawn id; ``FleetFence.verify``, called
by ``EpochLedger`` inside every mutating phase (stage intent, stage
shard, commit append), refuses a write whose token was superseded with a
typed ``FencedEpochError``.  A zombie from an older generation therefore
cannot merge into the re-sliced plan: its staged epoch stays uncommitted
and the next ``recover()`` quarantines it.

Worker death is detected by process exit and by lease expiry (a live but
stuck worker that stopped heartbeating); expiry escalates: drain SIGTERM,
``grace_seconds``, SIGKILL (fault site ``worker.kill``), ledger
``recover()`` of the uncommitted epoch, respawn under a fresh spawn id.
Workers drain on SIGTERM (the preemption notice): they finish the
in-flight trigger, commit or roll back, write a ``done`` lease with
reason ``preempted`` and exit 0; the supervisor respawns them.

Resize is ledger-gated: scale-out on sustained queue depth, scale-in on
idle, or a scripted ``resize_plan``, only between committed epochs.  The
whole fleet drains, every worker ledger recovers, then the new
generation's record lands in ``fleet.jsonl`` and the new worker set
spawns against the re-sliced file partition (``partition_of``), seeded
with the union of every worker's committed sources.

Chaos: ``STC_FAULTS`` reaches generation-0 workers only (recovery must
run clean), and ``worker_faults`` pins a spec to one worker index.
Supervisor-side sites: ``supervisor.spawn`` and ``worker.kill``.

Telemetry, under the JAX package's names: the ``fleet.*`` counters and
the ``fleet.workers`` gauge, one ``fleet_*`` event a transition (spawn,
preempt, kill, respawn, resize, crash, lease expiry, exit, sweep,
converged) and a ``lease_sync`` clock anchor a lease renewal, into the
supervisor's own run stream (``supervise --telemetry-file``); the
``ledger.fence_refusals`` counter and a ``fence_refused`` event where a
fence refuses a write, and ``fleet.heartbeats`` a lease renewal, in the
worker's stream.  The supervisor holds one trace (the adopted
``STC_TRACE`` or a fresh one): each spawn gets a child span of it in its
environment, which the worker adopts and stamps on its lease renewals,
its stream and its ledger records, and every fleet ledger record of a
spawn set carries its ``trace_id``.

``ServeFleetSupervisor`` runs N ``serve`` replicas as one service: no
epoch ledgers, a staggered bring-up, a drain-free resize, a rolling
hot-swap through per-replica control files and a parallel drain (its
docstring).

``actions_file`` closes the loop from telemetry to topology, as in the JAX
package: a ``monitor`` (``telemetry.alerts``) writes scale and drain
requests there, and every sweep applies the new ones (a resize through
``_resize``, a drain through the escalation ladder) and acks the last
applied id in ``<actions_file>.ack``, so a request is applied exactly once
across supervisor restarts.

This module imports neither ``torch`` nor the port's device code: it is
subprocess-and-files machinery that must survive whatever a worker does
to the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from . import faultinject
from .errors import FencedEpochError, ResilienceError
from .integrity import atomic_write_text
from .ledger import EpochLedger, record_checksum
from .retry import RetryGiveUp, retry_call
from .retry import sleep as _sleep

__all__ = [
    "FLEET_LOG_NAME",
    "LEASE_DIRNAME",
    "CONTROL_DIRNAME",
    "FleetLedger",
    "FleetFence",
    "WorkerLease",
    "read_lease",
    "read_control",
    "PreemptionNotice",
    "partition_of",
    "worker_dir",
    "lease_path",
    "control_path",
    "fleet_committed_sources",
    "fleet_committed_epochs",
    "FleetReport",
    "FleetSupervisor",
    "ServeFleetSupervisor",
]

FLEET_LOG_NAME = "fleet.jsonl"
LEASE_DIRNAME = "leases"
CONTROL_DIRNAME = "control"

# metric names (declared in telemetry/names.py)
WORKERS_GAUGE = "fleet.workers"
SPAWNS_COUNTER = "fleet.spawns"
RESPAWNS_COUNTER = "fleet.respawns"
RESIZES_COUNTER = "fleet.resizes"
PREEMPTIONS_COUNTER = "fleet.preemptions"
LEASE_EXPIRIES_COUNTER = "fleet.lease_expiries"
CRASHES_COUNTER = "fleet.crashes"
HEARTBEATS_COUNTER = "fleet.heartbeats"
FENCE_REFUSALS_COUNTER = "ledger.fence_refusals"
ACTIONS_APPLIED_COUNTER = "fleet.actions_applied"
SWAP_ROLLS_COUNTER = "fleet.swap_rolls"
SWAP_STALLS_COUNTER = "fleet.swap_stalls"


def worker_dir(fleet_dir: str, index: int) -> str:
    """Per-worker epoch-ledger checkpoint dir inside the fleet dir."""
    return os.path.join(fleet_dir, f"w{index:03d}")


def lease_path(fleet_dir: str, index: int) -> str:
    return os.path.join(fleet_dir, LEASE_DIRNAME, f"w{index:03d}.json")


def control_path(fleet_dir: str, index: int) -> str:
    """Per-replica control file of a serve fleet (the supervisor's half
    of a rolling swap; the lease is the replica's half)."""
    return os.path.join(fleet_dir, CONTROL_DIRNAME, f"w{index:03d}.json")


def partition_of(name: str, worker_count: int) -> int:
    """Deterministic file -> worker assignment: every worker derives the
    same partition from the basename alone, so ingest needs no
    cross-process agreement, and the mapping survives a moved watch dir.
    SHA-256 rather than crc32, whose low bits barely mix for
    run-numbered names (``doc00..doc07`` all land even)."""
    digest = hashlib.sha256(
        os.path.basename(name).encode("utf-8")
    ).digest()
    return int.from_bytes(digest[:8], "big") % max(1, worker_count)


# ---------------------------------------------------------------------------
# Fleet ledger + fence
# ---------------------------------------------------------------------------
class FleetLedger:
    """Append-only, checksummed log of fleet topology transitions.

    One record per spawn/respawn/resize::

        {"schema": 1, "kind": "spawn|respawn|resize|resume",
         "generation": 3, "worker_count": 2,
         "spawn_ids": {"0": 5, "1": 1}, "reason": "...",
         "checksum": "<sha256 of the body>"}

    The newest record is the fence: it names, for every live worker
    index, the spawn id whose writes are valid.  A torn last line (a
    supervisor crash mid-append) is ignored on read, as in
    ``epochs.jsonl``.
    """

    def __init__(self, fleet_dir: str) -> None:
        self.fleet_dir = fleet_dir
        self.path = os.path.join(fleet_dir, FLEET_LOG_NAME)

    def records(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "r", encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n") if ln.strip()]
        out: List[Dict] = []
        for i, ln in enumerate(lines):
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break               # torn tail: ignore
                raise
            if record_checksum(rec) != rec.get("checksum"):
                if i == len(lines) - 1:
                    break
                raise ResilienceError(
                    f"{self.path}: fleet record {i + 1} checksum "
                    f"mismatch (not the final line)"
                )
            out.append(rec)
        return out

    def current(self) -> Optional[Dict]:
        recs = self.records()
        return recs[-1] if recs else None

    def append(
        self,
        *,
        kind: str,
        generation: int,
        worker_count: int,
        spawn_ids: Dict[int, int],
        **extra,
    ) -> Dict:
        rec = {
            "schema": 1,
            "kind": kind,
            "generation": int(generation),
            "worker_count": int(worker_count),
            "spawn_ids": {str(k): int(v) for k, v in spawn_ids.items()},
            "ts": time.time(),
            **extra,
        }
        rec["checksum"] = record_checksum(rec)
        os.makedirs(self.fleet_dir, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec


@dataclass(frozen=True)
class FleetFence:
    """A worker's fence token, checked by ``EpochLedger`` before every
    mutating ledger phase.  ``verify()`` re-reads the fleet ledger, so a
    resize that landed after this worker was spawned is seen on its next
    write."""

    fleet_dir: str
    generation: int
    worker_index: int
    spawn_id: int

    def verify(self) -> None:
        from .. import telemetry

        cur = FleetLedger(self.fleet_dir).current()
        if cur is None:
            return                      # no fence state yet: standalone
        ok = (
            int(cur.get("generation", -1)) == self.generation
            and cur.get("spawn_ids", {}).get(str(self.worker_index))
            == self.spawn_id
        )
        if ok:
            return
        telemetry.count(FENCE_REFUSALS_COUNTER)
        telemetry.event(
            "fence_refused",
            worker=self.worker_index,
            generation=self.generation,
            spawn_id=self.spawn_id,
            current_generation=cur.get("generation"),
        )
        raise FencedEpochError(
            self.fleet_dir,
            f"worker {self.worker_index} token (generation "
            f"{self.generation}, spawn {self.spawn_id}) superseded by "
            f"generation {cur.get('generation')} "
            f"({cur.get('kind', '?')}) — staged shards refused",
        )


# ---------------------------------------------------------------------------
# Worker-side lease + preemption notice
# ---------------------------------------------------------------------------
def read_lease(path: str) -> Optional[Dict]:
    """A worker's latest lease, or None (a missing or torn lease file
    reads as absent: the supervisor treats that as staleness)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def read_control(path: str) -> Optional[Dict]:
    """A replica's latest control-file command, or None (a missing, torn
    or non-object file reads as no command yet)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


class WorkerLease:
    """Worker-side heartbeat writer: one small JSON lease file renewed at
    most every ``interval`` seconds (atomic tmp+rename, so the supervisor
    never reads a torn lease).  It carries the fence token, the source's
    queue depth (the supervisor's scale-out signal) and the last committed
    epoch.  ``mark_done`` publishes the terminal state; a crash cannot
    write it, which is how the supervisor tells a clean exit from a
    death."""

    def __init__(
        self,
        path: str,
        *,
        interval: float = 0.5,
        worker_index: int = 0,
        generation: int = 0,
        spawn_id: int = 0,
        static_fields: Optional[Dict] = None,
    ) -> None:
        self.path = path
        self.interval = float(interval)
        self.worker_index = int(worker_index)
        self.generation = int(generation)
        self.spawn_id = int(spawn_id)
        # constant identity riders on every renewal (a serve replica's
        # role="serve", which the routing front keys on)
        self.static_fields = dict(static_fields or {})
        self._last = 0.0

    def _write(self, **fields) -> None:
        from .. import telemetry
        from ..telemetry import tracing

        payload = {
            "pid": os.getpid(),
            "worker": self.worker_index,
            "generation": self.generation,
            "spawn_id": self.spawn_id,
            "ts": time.time(),
            # the adopted trace rides every renewal, so whatever reads
            # the leases sees which trace owns the pid
            **tracing.fields(),
            **self.static_fields,
            **fields,
        }

        def _put() -> None:
            faultinject.check("worker.heartbeat")
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            atomic_write_text(
                self.path, json.dumps(payload, sort_keys=True) + "\n"
            )

        retry_call(_put, site="worker.heartbeat")
        telemetry.count(HEARTBEATS_COUNTER)

    def beat(
        self,
        *,
        queue_depth: int = 0,
        epoch: int = -1,
        force: bool = False,
        **extra,
    ) -> bool:
        """Renew the lease (rate-limited); True when a write happened.
        ``extra`` fields ride the renewal as they are (a serve replica's
        ``state``, ``port``, ``model_path`` and ``model_stamp``)."""
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return False
        self._write(queue_depth=int(queue_depth), epoch=int(epoch), **extra)
        self._last = now
        return True

    def mark_done(self, reason: str, *, epoch: int = -1) -> None:
        """Publish the terminal lease state (``reason``: ``idle``, the
        source dried up; ``preempted``, drained after SIGTERM; ``fenced``,
        superseded by a resize).  Best-effort: a failing lease write must
        not keep a dying worker alive."""
        try:
            self._write(done=True, reason=reason, epoch=int(epoch))
        except (RetryGiveUp, OSError):
            pass                        # the exit code still tells

    def heartbeat_callback(self) -> Callable[[int], None]:
        """A ``stream(heartbeat=...)``-shaped callable bound to this lease
        (the poll loop forwards its queue depth)."""

        def _cb(queue_depth: int) -> None:
            self.beat(queue_depth=queue_depth)

        return _cb


class PreemptionNotice:
    """SIGTERM drain flag (a preemption notice): the handler only sets a
    flag, and the streaming loop finishes its in-flight trigger, commits
    or rolls back through the ledger, and stops.  ``install()`` replaces
    the process's SIGTERM handler; ``uninstall()`` puts back the one it
    replaced."""

    def __init__(self) -> None:
        self.requested = False
        self._previous = None

    def install(self) -> "PreemptionNotice":
        self._previous = signal.signal(signal.SIGTERM, self._handle)
        return self

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None

    def _handle(self, signum, frame) -> None:
        self.requested = True

    def __call__(self) -> bool:
        return self.requested

    def __bool__(self) -> bool:
        return self.requested


# ---------------------------------------------------------------------------
# Fleet-wide ledger reads
# ---------------------------------------------------------------------------
def _worker_dirs(fleet_dir: str) -> List[str]:
    try:
        names = sorted(os.listdir(fleet_dir))
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        p = os.path.join(fleet_dir, n)
        if len(n) == 4 and n.startswith("w") and n[1:].isdigit() \
                and os.path.isdir(p):
            out.append(p)
    return out


def fleet_committed_sources(fleet_dir: str) -> Set[str]:
    """Union of committed source paths across every worker ledger: the
    seen-set a (re)spawned worker starts from, so a file committed by a
    worker that a resize retired never replays."""
    out: Set[str] = set()
    for wd in _worker_dirs(fleet_dir):
        out.update(EpochLedger(wd).committed_sources())
    return out


def fleet_committed_epochs(fleet_dir: str) -> int:
    """Total committed epochs across the fleet (the resize plan's clock)."""
    return sum(
        EpochLedger(wd).last_committed() + 1
        for wd in _worker_dirs(fleet_dir)
    )


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------
@dataclass
class _Worker:
    index: int
    spawn_id: int
    generation: int
    proc: subprocess.Popen
    spawned_at: float
    drain_requested: bool = False
    finished: bool = False
    finished_reason: str = ""


@dataclass
class FleetReport:
    """What one ``FleetSupervisor.run()`` did."""

    converged: bool = False
    final_workers: int = 0
    spawns: int = 0
    respawns: int = 0
    resizes: int = 0
    lease_expiries: int = 0
    preemptions: int = 0
    crashes: int = 0
    committed_epochs: int = 0
    swap_rolls: int = 0
    sweeps: int = 0
    resize_history: List[int] = field(default_factory=list)


class FleetSupervisor:
    """Spawn, lease-watch, escalate and resize a worker fleet.

    ``worker_argv(index, count, generation, spawn_id)`` builds one
    worker's command line (the CLI's ``supervise`` verb builds
    ``stream-train`` / ``stream-score`` invocations of the port's CLI;
    tests substitute stub workers).
    """

    def __init__(
        self,
        fleet_dir: str,
        worker_argv: Callable[[int, int, int, int], Sequence[str]],
        *,
        workers: int = 2,
        min_workers: int = 1,
        max_workers: int = 8,
        lease_timeout: float = 3.0,
        grace_seconds: float = 2.0,
        startup_grace_seconds: float = 60.0,
        sweep_interval: float = 0.25,
        scale_out_depth: Optional[int] = None,
        scale_out_sweeps: int = 3,
        scale_in_sweeps: Optional[int] = None,
        max_respawns: int = 5,
        resize_plan: Optional[List[Dict]] = None,
        worker_faults: Optional[Dict[int, str]] = None,
        env: Optional[Dict[str, str]] = None,
        actions_file: Optional[str] = None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.fleet_dir = fleet_dir
        self.worker_argv = worker_argv
        self.workers = int(workers)
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.lease_timeout = float(lease_timeout)
        self.grace_seconds = float(grace_seconds)
        self.startup_grace_seconds = float(startup_grace_seconds)
        self.sweep_interval = float(sweep_interval)
        self.scale_out_depth = scale_out_depth
        self.scale_out_sweeps = max(1, int(scale_out_sweeps))
        self.scale_in_sweeps = scale_in_sweeps
        self.max_respawns = int(max_respawns)
        # [{"at_epochs": E, "workers": N}, ...]: resize to N once the
        # fleet's total committed epochs reach E (drills and planned
        # scaling; queue-depth scaling stays independent)
        self.resize_plan = sorted(
            resize_plan or [], key=lambda r: r["at_epochs"]
        )
        self.worker_faults = dict(worker_faults or {})
        self.env = dict(env) if env is not None else dict(os.environ)
        # a monitor's scale and drain requests, polled every sweep; the
        # last applied id is acked in <actions_file>.ack, so a request is
        # applied exactly once across supervisor restarts
        self.actions_file = actions_file
        self._actions_stamp: Optional[Tuple[float, int]] = None
        self._last_action_id = -1
        if actions_file:
            self._last_action_id = self._read_action_ack()

        self.ledger = FleetLedger(fleet_dir)
        self.report = FleetReport()
        self.generation = 0
        self._next_spawn_id = 0
        self._procs: Dict[int, _Worker] = {}
        self._depth_streak = 0
        self._idle_streak = 0
        # the causal root: each spawn gets a child span of it in its
        # environment (STC_TRACE), so one trace id covers supervisor,
        # worker, ledger and publish
        from ..telemetry import tracing

        self.trace = tracing.current() or tracing.mint()
        # newest lease ts seen per worker: a lease_sync event (the clock
        # anchor of `metrics trace --causal`) a renewal, not a sweep
        self._lease_sync: Dict[int, float] = {}

    # -- spawning --------------------------------------------------------
    def _worker_env(self, index: int, chaos: bool,
                    trace=None) -> Dict[str, str]:
        from ..telemetry import tracing

        env = {
            k: v for k, v in self.env.items()
            if k not in (faultinject.ENV_SPEC, faultinject.ENV_SEED)
        }
        # the worker adopts this span at start-up (tracing.adopt_env) and
        # stamps it on its lease renewals and ledger records
        env.update(tracing.env_for_child(trace))
        # STC_FAULTS reaches each worker's first generation-0 spawn only:
        # the injected crash is the drill, and recovery must run clean (a
        # respawn that inherited kill@1 would die forever)
        if chaos:
            spec = self.worker_faults.get(
                index, self.env.get(faultinject.ENV_SPEC)
            )
            if spec:
                env[faultinject.ENV_SPEC] = spec
                env[faultinject.ENV_SEED] = self.env.get(
                    faultinject.ENV_SEED, "0"
                )
        return env

    def _spawn(
        self, index: int, count: int, spawn_id: int, *,
        chaos: bool = False,
    ) -> _Worker:
        from .. import telemetry

        argv = list(
            self.worker_argv(index, count, self.generation, spawn_id)
        )
        # one child span a spawn: the env hands it to the worker, the
        # fleet_spawn event anchors the supervisor's end of the edge
        span = self.trace.child()

        def _launch() -> subprocess.Popen:
            faultinject.check("supervisor.spawn")
            return subprocess.Popen(
                argv,
                env=self._worker_env(index, chaos, trace=span),
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )

        proc = retry_call(_launch, site="supervisor.spawn")
        w = _Worker(
            index=index,
            spawn_id=spawn_id,
            generation=self.generation,
            proc=proc,
            spawned_at=time.time(),
        )
        self._procs[index] = w
        self.report.spawns += 1
        telemetry.count(SPAWNS_COUNTER)
        telemetry.event(
            "fleet_spawn",
            worker=index, pid=proc.pid,
            generation=self.generation, spawn_id=spawn_id,
            **span.to_fields(),
        )
        return w

    def _spawn_set(self, count: int, *, kind: str, **extra) -> None:
        """Issue fresh spawn ids for ``count`` workers, append the fence
        record first (so every new token verifies), then spawn."""
        from .. import telemetry

        spawn_ids = {}
        for i in range(count):
            spawn_ids[i] = self._next_spawn_id
            self._next_spawn_id += 1
        self.ledger.append(
            kind=kind,
            generation=self.generation,
            worker_count=count,
            spawn_ids=spawn_ids,
            trace_id=self.trace.trace_id,
            **extra,
        )
        for i in range(count):
            self._spawn(
                i, count, spawn_ids[i],
                chaos=kind == "spawn" and self.generation == 0,
            )
        telemetry.gauge(WORKERS_GAUGE, count)

    # -- killing ---------------------------------------------------------
    def _signal(self, w: _Worker, sig) -> None:
        try:
            w.proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass                        # already gone

    def _await_exit(self, w: _Worker, timeout: float) -> Optional[int]:
        deadline = time.monotonic() + timeout
        while True:
            rc = w.proc.poll()
            if rc is not None:
                return rc
            if time.monotonic() >= deadline:
                return None
            _sleep(min(0.05, self.sweep_interval))

    def _escalate(self, w: _Worker, *, why: str) -> None:
        """The kill ladder: drain SIGTERM, grace, SIGKILL, reap.  After
        this returns the pid is reaped; the fence handles any zombie
        write."""
        from .. import telemetry

        w.drain_requested = True
        self._signal(w, signal.SIGTERM)
        telemetry.count(PREEMPTIONS_COUNTER)
        telemetry.event(
            "fleet_preempt", worker=w.index, pid=w.proc.pid, why=why,
        )
        if self._await_exit(w, self.grace_seconds) is None:
            faultinject.check("worker.kill")
            self._signal(w, signal.SIGKILL)
            telemetry.event(
                "fleet_kill", worker=w.index, pid=w.proc.pid, why=why,
            )
            w.proc.wait()

    def _recover_worker(self, index: int) -> None:
        wd = worker_dir(self.fleet_dir, index)
        if os.path.isdir(wd):
            EpochLedger(wd).recover()

    def _handle_death(self, w: _Worker, *, cause: str) -> None:
        """Roll the dead worker's ledger back and respawn it under a fresh
        spawn id (same topology).  The respawn's fence record supersedes
        the dead incarnation's token, on top of the SIGKILL and reap."""
        from .. import telemetry

        self._recover_worker(w.index)
        self.report.respawns += 1
        if self.report.respawns > self.max_respawns:
            raise ResilienceError(
                f"fleet exceeded the respawn budget "
                f"({self.max_respawns}) — last death: worker "
                f"{w.index} ({cause}); aborting supervision"
            )
        telemetry.count(RESPAWNS_COUNTER)
        telemetry.event(
            "fleet_respawn", worker=w.index, cause=cause,
            generation=self.generation,
        )
        count = self._current_count()
        spawn_id = self._next_spawn_id
        self._next_spawn_id += 1
        spawn_ids = {
            i: ww.spawn_id
            for i, ww in self._procs.items()
            if not ww.finished and i != w.index
        }
        spawn_ids[w.index] = spawn_id
        self.ledger.append(
            kind="respawn",
            generation=self.generation,
            worker_count=count,
            spawn_ids=spawn_ids,
            worker=w.index,
            cause=cause,
        )
        self._spawn(w.index, count, spawn_id)

    def _current_count(self) -> int:
        cur = self.ledger.current()
        return int(cur["worker_count"]) if cur else self.workers

    # -- resize ----------------------------------------------------------
    def _resize(self, new_count: int, *, why: str) -> None:
        """Ledger-gated topology change: drain the whole fleet between
        committed epochs, recover every worker ledger, then commit the new
        generation to the fleet ledger and spawn the re-sliced set."""
        from .. import telemetry

        old = self._current_count()
        new_count = max(self.min_workers, min(self.max_workers, new_count))
        if new_count == old:
            return
        self.report.resizes += 1
        self.report.resize_history.append(new_count)
        telemetry.count(RESIZES_COUNTER)
        telemetry.event(
            "fleet_resize", workers_from=old, workers_to=new_count,
            why=why, generation=self.generation,
        )
        # every active worker gets the preemption notice; one that cannot
        # drain within grace is SIGKILLed (its epoch rolls back below)
        active = [
            w for w in self._procs.values() if not w.finished
        ]
        for w in active:
            self._escalate(w, why=f"resize_{why}")
        for w in active:
            w.proc.wait()
        for i in range(max(old, new_count)):
            self._recover_worker(i)
        self.generation += 1
        self._procs.clear()
        self._depth_streak = 0
        self._idle_streak = 0
        self._spawn_set(new_count, kind="resize", why=why)

    def _check_resize(self, depths: Dict[int, int]) -> None:
        # the scripted plan first (deterministic drills, planned scaling)
        if self.resize_plan:
            done = fleet_committed_epochs(self.fleet_dir)
            nxt = self.resize_plan[0]
            if done >= int(nxt["at_epochs"]):
                self.resize_plan.pop(0)
                self._resize(int(nxt["workers"]), why="plan")
                return
        count = self._current_count()
        if depths and len(depths) == count:
            total = sum(depths.values())
            if (
                self.scale_out_depth is not None
                and total >= self.scale_out_depth
            ):
                self._depth_streak += 1
            else:
                self._depth_streak = 0
            if total == 0:
                self._idle_streak += 1
            else:
                self._idle_streak = 0
            if (
                self.scale_out_depth is not None
                and self._depth_streak >= self.scale_out_sweeps
                and count < self.max_workers
            ):
                self._resize(count + 1, why="queue_depth")
            elif (
                self.scale_in_sweeps is not None
                and self._idle_streak >= self.scale_in_sweeps
                and count > self.min_workers
            ):
                self._resize(count - 1, why="idle")

    # -- the loop --------------------------------------------------------
    # -- the monitor's actions (the other half of the loop) --------------
    def _ack_path(self) -> str:
        return self.actions_file + ".ack"

    def _read_action_ack(self) -> int:
        try:
            with open(self._ack_path(), "r", encoding="utf-8") as f:
                return int(json.load(f).get("last_id", -1))
        except (OSError, json.JSONDecodeError, ValueError):
            return -1

    def _check_actions(self) -> None:
        """Apply the new requests of the monitor's actions file: a
        ``scale_out``, ``scale_in`` or ``resize`` goes through the
        role's ``_resize`` (a stream fleet's ledger-gated one, a serve
        fleet's drain-free one), a ``drain`` runs the escalation ladder
        on one worker and respawns it.  Every id read is acked, a
        clamped or no-op request too, or a firing alert would apply it
        forever."""
        from .. import telemetry

        if not self.actions_file:
            return
        try:
            st = os.stat(self.actions_file)
            stamp = (st.st_mtime, st.st_size)
        except OSError:
            return
        if stamp == self._actions_stamp:
            return
        self._actions_stamp = stamp
        try:
            with open(self.actions_file, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return                      # mid-write; next sweep re-reads
        actions = doc.get("actions") if isinstance(doc, dict) else None
        if not isinstance(actions, list):
            return
        fresh = sorted(
            (
                a for a in actions
                if isinstance(a, dict)
                and isinstance(a.get("id"), int)
                and a["id"] > self._last_action_id
            ),
            key=lambda a: a["id"],
        )
        for act in fresh:
            kind = str(act.get("kind", ""))
            why = f"alert_{act.get('alert', '?')}"
            telemetry.count(ACTIONS_APPLIED_COUNTER)
            telemetry.event(
                "fleet_action", id=act["id"], kind=kind, why=why,
            )
            if kind in ("scale_out", "scale_in", "resize"):
                count = self._current_count()
                if kind == "resize":
                    target = int(act.get("workers", count))
                else:
                    delta = int(act.get("workers_delta", 1))
                    target = count + (
                        delta if kind == "scale_out" else -delta
                    )
                self._resize(target, why=why)
            elif kind == "drain":
                w = self._procs.get(int(act.get("worker", -1)))
                if w is not None and not w.finished \
                        and w.proc.poll() is None:
                    self._escalate(w, why=why)
                    self._handle_death(w, cause=why)
            self._last_action_id = act["id"]
        if fresh:
            atomic_write_text(
                self._ack_path(),
                json.dumps(
                    {"last_id": self._last_action_id},
                    sort_keys=True,
                ) + "\n",
            )

    # -- the loop --------------------------------------------------------
    def run(self) -> FleetReport:
        from .. import telemetry

        os.makedirs(
            os.path.join(self.fleet_dir, LEASE_DIRNAME), exist_ok=True
        )
        cur = self.ledger.current()
        if cur is not None:
            # resumed supervision: adopt the last topology and bump the
            # generation, so a straggler of the dead fleet is fenced the
            # moment it writes
            self.generation = int(cur.get("generation", 0)) + 1
            self.workers = int(cur.get("worker_count", self.workers))
            ids = cur.get("spawn_ids", {})
            if ids:
                self._next_spawn_id = max(int(v) for v in ids.values()) + 1
        for wd in _worker_dirs(self.fleet_dir):
            EpochLedger(wd).recover()
        self._spawn_set(
            self.workers,
            kind="spawn" if cur is None else "resume",
        )
        try:
            while True:
                _sleep(self.sweep_interval)
                self.report.sweeps += 1
                if self._sweep():
                    break
        finally:
            # never leave orphans: whatever still runs when the loop exits
            # (converged, respawn budget spent, ^C) dies
            for w in self._procs.values():
                if w.proc.poll() is None:
                    self._signal(w, signal.SIGKILL)
                    w.proc.wait()
        self.report.converged = True
        self.report.final_workers = self._current_count()
        self.report.committed_epochs = fleet_committed_epochs(
            self.fleet_dir
        )
        telemetry.event(
            "fleet_converged",
            workers=self.report.final_workers,
            committed_epochs=self.report.committed_epochs,
            resizes=self.report.resizes,
            respawns=self.report.respawns,
        )
        return self.report

    def _sweep(self) -> bool:
        """One supervision sweep; True when the fleet converged (every
        worker finished cleanly)."""
        from .. import telemetry

        now = time.time()
        depths: Dict[int, int] = {}
        slack_min: Optional[float] = None
        for i, w in sorted(self._procs.items()):
            if w.finished:
                continue
            lease = read_lease(lease_path(self.fleet_dir, i))
            if lease is not None and (
                int(lease.get("spawn_id", -1)) != w.spawn_id
            ):
                lease = None            # stale file from a dead spawn
            rc = w.proc.poll()
            if lease is not None and lease.get("done"):
                if rc is None:
                    continue            # exiting; reap next sweep
                reason = str(lease.get("reason", "idle"))
                if reason == "preempted" and not w.drain_requested:
                    # an external preemption notice (we never asked): the
                    # worker drained cleanly; survive it
                    telemetry.count(PREEMPTIONS_COUNTER)
                    self.report.preemptions += 1
                    telemetry.event(
                        "fleet_preempted_externally", worker=i,
                    )
                    self._handle_death(w, cause="preemption")
                else:
                    w.finished = True
                    w.finished_reason = reason
                    telemetry.event(
                        "fleet_exit", worker=i, reason=reason, rc=rc,
                    )
                continue
            if rc is not None:
                # death without a done lease: a crash (or an injected
                # kill); recover and respawn
                self.report.crashes += 1
                telemetry.count(CRASHES_COUNTER)
                telemetry.event(
                    "fleet_crash", worker=i, rc=rc,
                    generation=w.generation,
                )
                self._handle_death(w, cause=f"exit_{rc}")
                continue
            # running: judge the lease's freshness
            if lease is None:
                age = now - w.spawned_at
                budget = self.startup_grace_seconds
            else:
                age = now - float(lease.get("ts", 0.0))
                budget = self.lease_timeout
                depths[i] = int(lease.get("queue_depth", 0))
                # clock anchor: the worker's lease ts beside the
                # supervisor's observation; `metrics trace --causal`
                # takes the least delta a worker as its skew correction
                lts = float(lease.get("ts", 0.0))
                if self._lease_sync.get(i) != lts:
                    self._lease_sync[i] = lts
                    telemetry.event(
                        "lease_sync", worker=i, lease_ts=lts,
                        observed_ts=now,
                    )
                # slack against the steady lease budget only (the
                # start-up grace would drown it)
                slack = budget - age
                slack_min = slack if slack_min is None else min(
                    slack_min, slack
                )
            if age > budget:
                telemetry.count(LEASE_EXPIRIES_COUNTER)
                self.report.lease_expiries += 1
                telemetry.event(
                    "fleet_lease_expired", worker=i,
                    age_seconds=round(age, 3),
                    pid=w.proc.pid,
                )
                self._escalate(w, why="lease_expiry")
                self._handle_death(w, cause="lease_expiry")
        active = [w for w in self._procs.values() if not w.finished]
        telemetry.gauge(WORKERS_GAUGE, len(active))
        telemetry.event(
            "fleet_sweep",
            workers=len(active),
            queue_depth=sum(depths.values()),
            **(
                {"lease_slack_min": round(slack_min, 3)}
                if slack_min is not None else {}
            ),
        )
        if not active:
            return True
        self._check_actions()
        self._check_resize(depths)
        return False


# ---------------------------------------------------------------------------
# The serve fleet: N hot scoring replicas as a worker role
# ---------------------------------------------------------------------------
class ServeFleetSupervisor(FleetSupervisor):
    """Supervise N ``serve`` replicas as one logical service.

    The lease, escalation and fleet-ledger machinery of the stream
    fleets, with what replication implies:

      * **No epoch ledgers.**  Replicas are stateless readers of a
        published model; recovery is a respawn, not a rollback.  A dead
        replica's lease is retired before its respawn, so the routing
        front drops it at once.
      * **Staggered bring-up.**  Replica 0 (the canary) spawns first;
        replicas 1..N-1 spawn once its lease says ``ready`` or the
        startup grace passes.  The port has no executable cache, so the
        stagger only lets the canary make its CUDA context and load the
        per-document kernel (building it if missing) first.
      * **Drain-free resize.**  Replicas serve disjoint requests, not a
        partitioned file corpus: scale-out spawns new replicas next to
        the serving ones and scale-in drains only the retired indices,
        so the fleet never stops answering (ledger records still fence
        each topology).
      * **Rolling hot-swap.**  The supervisor watches ``models_dir`` for
        a newer COMMITted publish and rolls it replica by replica
        through per-replica control files; a replica acks by reporting
        the new ``model_stamp`` in its lease.  At most one replica swaps
        at a time, and the routing front keeps a client stream on the
        old generation until it is gone from the fleet, so one stream
        never sees generations interleave.
      * **Run until stopped.**  A serve fleet never converges: the loop
        ends when ``stop`` (a SIGTERM ``PreemptionNotice``) fires,
        ``request_stop`` is called or ``max_seconds`` pass, and drains
        every replica in parallel (SIGTERM, grace, SIGKILL).

    A monitor's ``serve_p99`` or ``serve_batch_fill`` alert scales this
    fleet through the ``actions_file`` protocol of the stream fleets:
    ``scale_out`` spawns a replica beside the serving ones, ``drain``
    bounces one through the ladder, each applied exactly once (the CLI
    resizes a serve fleet this way only).
    """

    def __init__(
        self,
        fleet_dir: str,
        worker_argv: Callable[[int, int, int, int], Sequence[str]],
        *,
        models_dir: Optional[str] = None,
        lang: str = "EN",
        stop: Optional[Callable[[], bool]] = None,
        max_seconds: Optional[float] = None,
        swap_timeout: float = 60.0,
        **kw,
    ) -> None:
        super().__init__(fleet_dir, worker_argv, **kw)
        self.models_dir = models_dir
        self.lang = lang
        self.stop = stop
        self.max_seconds = max_seconds
        self.swap_timeout = float(swap_timeout)
        self._stop_flag = False
        self._stopping = False
        self._deadline = (
            time.monotonic() + float(max_seconds)
            if max_seconds is not None else None
        )
        # replicas deferred until the canary (lowest index) is ready
        self._deferred: List[Tuple[int, int]] = []
        self._deferred_deadline = 0.0
        # the rolling-swap state machine (one replica in flight at a time)
        self._roll: Optional[Dict] = None
        self._next_control_id = 0
        self._target_stamp: Optional[int] = None
        if models_dir is not None:
            from ..serving.front import discover_latest_model_dir, model_stamp

            self._target_stamp = model_stamp(
                discover_latest_model_dir(models_dir, lang)
            )

    def request_stop(self) -> None:
        """Ask the loop to drain the fleet and exit (thread-safe)."""
        self._stop_flag = True

    # -- role overrides --------------------------------------------------
    def _recover_worker(self, index: int) -> None:
        # serve replicas keep no epoch ledger; recovery is the respawn
        pass

    def _handle_death(self, w: _Worker, *, cause: str) -> None:
        # retire the dead incarnation's lease before the respawn: the
        # front drops it from rotation at once
        try:
            os.remove(lease_path(self.fleet_dir, w.index))
        except OSError:
            pass
        if self._stopping:
            w.finished = True
            w.finished_reason = cause
            return
        super()._handle_death(w, cause=cause)

    def _spawn_set(self, count: int, *, kind: str, **extra) -> None:
        """The fence record for the whole set, then a staggered spawn: the
        canary (lowest index) first, the rest once it is ready or the
        startup grace passes."""
        from .. import telemetry

        spawn_ids = {}
        for i in range(count):
            spawn_ids[i] = self._next_spawn_id
            self._next_spawn_id += 1
        self.ledger.append(
            kind=kind,
            generation=self.generation,
            worker_count=count,
            spawn_ids=spawn_ids,
            trace_id=self.trace.trace_id,
            **extra,
        )
        chaos = kind == "spawn" and self.generation == 0
        if count > 1:
            self._spawn(0, count, spawn_ids[0], chaos=chaos)
            self._deferred = [(i, spawn_ids[i]) for i in range(1, count)]
            self._deferred_deadline = (
                time.monotonic() + self.startup_grace_seconds
            )
        else:
            for i in range(count):
                self._spawn(i, count, spawn_ids[i], chaos=chaos)
        telemetry.gauge(WORKERS_GAUGE, count)

    def _spawn_deferred_if_ready(self) -> None:
        if not self._deferred:
            return
        canary = min(
            (i for i, w in self._procs.items() if not w.finished),
            default=None,
        )
        ready = False
        if canary is not None:
            lease = read_lease(lease_path(self.fleet_dir, canary))
            ready = (
                lease is not None
                and lease.get("state") == "ready"
                and int(lease.get("spawn_id", -1))
                == self._procs[canary].spawn_id
            )
        if not ready and time.monotonic() < self._deferred_deadline:
            return
        deferred, self._deferred = self._deferred, []
        count = self._current_count()
        for i, sid in deferred:
            self._spawn(i, count, sid)

    def _resize(self, new_count: int, *, why: str) -> None:
        """Drain-free resize: grow by spawning fresh replicas next to the
        serving set, shrink by draining only the retired (highest)
        indices.  The fleet keeps answering throughout."""
        from .. import telemetry

        old = self._current_count()
        new_count = max(self.min_workers, min(self.max_workers, new_count))
        if new_count == old or self._stopping:
            return
        self.report.resizes += 1
        self.report.resize_history.append(new_count)
        telemetry.count(RESIZES_COUNTER)
        telemetry.event(
            "fleet_resize", workers_from=old, workers_to=new_count,
            why=why, generation=self.generation, role="serve",
        )
        live = {
            i: w.spawn_id for i, w in self._procs.items() if not w.finished
        }
        if new_count > old:
            fresh = {}
            for i in range(old, new_count):
                fresh[i] = self._next_spawn_id
                self._next_spawn_id += 1
            self.ledger.append(
                kind="resize",
                generation=self.generation,
                worker_count=new_count,
                spawn_ids={**live, **fresh},
                why=why,
            )
            for i, sid in fresh.items():
                self._spawn(i, new_count, sid)
        else:
            retire = [
                i for i in sorted(self._procs, reverse=True)
                if not self._procs[i].finished
            ][: old - new_count]
            keep = {i: sid for i, sid in live.items() if i not in retire}
            self.ledger.append(
                kind="resize",
                generation=self.generation,
                worker_count=new_count,
                spawn_ids=keep,
                why=why,
            )
            for i in retire:
                w = self._procs.pop(i)
                self._escalate(w, why=f"resize_{why}")
                w.proc.wait()
                for p in (
                    lease_path(self.fleet_dir, i),
                    control_path(self.fleet_dir, i),
                ):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        telemetry.gauge(WORKERS_GAUGE, new_count)

    # -- rolling hot-swap ------------------------------------------------
    def _issue_swap(self, index: int, path: str, stamp: int) -> None:
        self._next_control_id += 1
        os.makedirs(
            os.path.join(self.fleet_dir, CONTROL_DIRNAME), exist_ok=True
        )
        atomic_write_text(
            control_path(self.fleet_dir, index),
            json.dumps(
                {
                    "id": self._next_control_id,
                    "swap_to": path,
                    "stamp": int(stamp),
                },
                sort_keys=True,
            ) + "\n",
        )

    def _maybe_start_roll(self) -> None:
        from .. import telemetry

        if self.models_dir is None or self._stopping:
            return
        from ..serving.front import discover_latest_model_dir, model_stamp

        latest = discover_latest_model_dir(self.models_dir, self.lang)
        stamp = model_stamp(latest)
        if stamp is None:
            return
        if self._target_stamp is not None and stamp <= self._target_stamp:
            return
        queue = sorted(i for i, w in self._procs.items() if not w.finished)
        if not queue:
            return
        self.report.swap_rolls += 1
        telemetry.count(SWAP_ROLLS_COUNTER)
        telemetry.event(
            "fleet_swap_roll", target=latest, stamp=stamp,
            replicas=len(queue),
        )
        self._roll = {
            "path": latest,
            "stamp": int(stamp),
            "queue": queue,
            "current": None,
            "deadline": 0.0,
            "swaps": {},
        }

    def _advance_roll(self) -> None:
        from .. import telemetry

        if self._roll is None:
            self._maybe_start_roll()
            if self._roll is None:
                return
        r = self._roll
        cur = r["current"]
        if cur is None:
            if not r["queue"]:
                swaps = r["swaps"]
                lag = (
                    round(max(swaps.values()) - min(swaps.values()), 6)
                    if len(swaps) >= 2 else 0.0
                )
                telemetry.event(
                    "fleet_swap_roll_done",
                    stamp=r["stamp"],
                    swapped=len(swaps),
                    swap_lag_seconds=lag,
                )
                self._target_stamp = r["stamp"]
                self._roll = None
                return
            nxt = r["queue"].pop(0)
            w = self._procs.get(nxt)
            if w is None or w.finished:
                return                  # retired mid-roll: skip it
            self._issue_swap(nxt, r["path"], r["stamp"])
            r["current"] = nxt
            r["deadline"] = time.monotonic() + self.swap_timeout
            return
        lease = read_lease(lease_path(self.fleet_dir, cur))
        got = None
        if lease is not None and not lease.get("done"):
            try:
                got = int(lease.get("model_stamp"))
            except (TypeError, ValueError):
                got = None
        if got is not None and got >= r["stamp"]:
            r["swaps"][cur] = time.time()
            telemetry.event(
                "fleet_replica_swapped",
                worker=cur, stamp=got, model=r["path"],
            )
            r["current"] = None
        elif time.monotonic() > r["deadline"]:
            # a stuck swap must not wedge the roll (the replica keeps
            # serving its verified old model; the stall is counted)
            telemetry.count(SWAP_STALLS_COUNTER)
            telemetry.event(
                "fleet_swap_stalled", worker=cur, stamp=r["stamp"],
            )
            r["current"] = None

    # -- lifecycle -------------------------------------------------------
    def _shutdown_fleet(self) -> None:
        """Drain every replica in parallel (SIGTERM all, grace, SIGKILL
        the stragglers) and mark the fleet finished."""
        from .. import telemetry

        self._stopping = True
        active = [w for w in self._procs.values() if not w.finished]
        for w in active:
            w.drain_requested = True
            self._signal(w, signal.SIGTERM)
        deadline = time.monotonic() + self.grace_seconds
        for w in active:
            left = max(0.05, deadline - time.monotonic())
            if self._await_exit(w, left) is None:
                self._signal(w, signal.SIGKILL)
                w.proc.wait()
            w.finished = True
            w.finished_reason = "shutdown"
        telemetry.event("fleet_shutdown", replicas=len(active))

    def _sweep(self) -> bool:
        if not self._stopping and (
            self._stop_flag
            or (self.stop is not None and self.stop())
            or (
                self._deadline is not None
                and time.monotonic() >= self._deadline
            )
        ):
            self._shutdown_fleet()
            return True
        done = super()._sweep()
        if done or self._stopping:
            return True
        self._spawn_deferred_if_ready()
        self._advance_roll()
        return False
