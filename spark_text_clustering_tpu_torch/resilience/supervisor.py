"""Elastic fleet supervisor: the lifecycle of a preemptible stream worker
fleet, copied from the JAX package (its ``resilience/supervisor.py``).

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

This module imports neither ``torch`` nor the port's device code: it is
subprocess-and-files machinery that must survive whatever a worker does
to the card.  The JAX package also records telemetry and trace context
here (ROADMAP queue 1 item 9c), applies a monitor's actions file (item
9b) and supervises serve replicas (item 8b); the port has none of these
yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

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
]

FLEET_LOG_NAME = "fleet.jsonl"
LEASE_DIRNAME = "leases"
CONTROL_DIRNAME = "control"


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
    ) -> None:
        self.path = path
        self.interval = float(interval)
        self.worker_index = int(worker_index)
        self.generation = int(generation)
        self.spawn_id = int(spawn_id)
        self._last = 0.0

    def _write(self, **fields) -> None:
        payload = {
            "pid": os.getpid(),
            "worker": self.worker_index,
            "generation": self.generation,
            "spawn_id": self.spawn_id,
            "ts": time.time(),
            **fields,
        }

        def _put() -> None:
            faultinject.check("worker.heartbeat")
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            atomic_write_text(
                self.path, json.dumps(payload, sort_keys=True) + "\n"
            )

        retry_call(_put, site="worker.heartbeat")

    def beat(
        self,
        *,
        queue_depth: int = 0,
        epoch: int = -1,
        force: bool = False,
    ) -> bool:
        """Renew the lease (rate-limited); True when a write happened."""
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return False
        self._write(queue_depth=int(queue_depth), epoch=int(epoch))
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

        self.ledger = FleetLedger(fleet_dir)
        self.report = FleetReport()
        self.generation = 0
        self._next_spawn_id = 0
        self._procs: Dict[int, _Worker] = {}
        self._depth_streak = 0
        self._idle_streak = 0

    # -- spawning --------------------------------------------------------
    def _worker_env(self, index: int, chaos: bool) -> Dict[str, str]:
        env = {
            k: v for k, v in self.env.items()
            if k not in (faultinject.ENV_SPEC, faultinject.ENV_SEED)
        }
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
        argv = list(
            self.worker_argv(index, count, self.generation, spawn_id)
        )

        def _launch() -> subprocess.Popen:
            faultinject.check("supervisor.spawn")
            return subprocess.Popen(
                argv,
                env=self._worker_env(index, chaos),
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
        return w

    def _spawn_set(self, count: int, *, kind: str, **extra) -> None:
        """Issue fresh spawn ids for ``count`` workers, append the fence
        record first (so every new token verifies), then spawn."""
        spawn_ids = {}
        for i in range(count):
            spawn_ids[i] = self._next_spawn_id
            self._next_spawn_id += 1
        self.ledger.append(
            kind=kind,
            generation=self.generation,
            worker_count=count,
            spawn_ids=spawn_ids,
            **extra,
        )
        for i in range(count):
            self._spawn(
                i, count, spawn_ids[i],
                chaos=kind == "spawn" and self.generation == 0,
            )

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
        w.drain_requested = True
        self._signal(w, signal.SIGTERM)
        if self._await_exit(w, self.grace_seconds) is None:
            faultinject.check("worker.kill")
            self._signal(w, signal.SIGKILL)
            w.proc.wait()

    def _recover_worker(self, index: int) -> None:
        wd = worker_dir(self.fleet_dir, index)
        if os.path.isdir(wd):
            EpochLedger(wd).recover()

    def _handle_death(self, w: _Worker, *, cause: str) -> None:
        """Roll the dead worker's ledger back and respawn it under a fresh
        spawn id (same topology).  The respawn's fence record supersedes
        the dead incarnation's token, on top of the SIGKILL and reap."""
        self._recover_worker(w.index)
        self.report.respawns += 1
        if self.report.respawns > self.max_respawns:
            raise ResilienceError(
                f"fleet exceeded the respawn budget "
                f"({self.max_respawns}) — last death: worker "
                f"{w.index} ({cause}); aborting supervision"
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
        old = self._current_count()
        new_count = max(self.min_workers, min(self.max_workers, new_count))
        if new_count == old:
            return
        self.report.resizes += 1
        self.report.resize_history.append(new_count)
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
    def run(self) -> FleetReport:
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
        return self.report

    def _sweep(self) -> bool:
        """One supervision sweep; True when the fleet converged (every
        worker finished cleanly)."""
        now = time.time()
        depths: Dict[int, int] = {}
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
                    self.report.preemptions += 1
                    self._handle_death(w, cause="preemption")
                else:
                    w.finished = True
                continue
            if rc is not None:
                # death without a done lease: a crash (or an injected
                # kill); recover and respawn
                self.report.crashes += 1
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
            if age > budget:
                self.report.lease_expiries += 1
                self._escalate(w, why="lease_expiry")
                self._handle_death(w, cause="lease_expiry")
        active = [w for w in self._procs.values() if not w.finished]
        if not active:
            return True
        self._check_resize(depths)
        return False
