"""The port's fleet supervisor, unit level: the file partition, the fleet
ledger and fence tokens, the worker lease, the lease-bounded retry
deadline, and the supervisor loop against stub workers (lease expiry,
SIGTERM then SIGKILL, crash and external-preemption respawns, queue-depth
scale-out, the respawn budget).  The JAX package's own tests of the same
machinery are copied here with their assertions, less the telemetry
counters (held against the JAX supervisor's in
``test_torch_fleet_telemetry.py``); the cross-package checks hold a fleet
dir, a lease and a fence interchangeable between the packages.

The stream workers themselves run in ``test_torch_fleet.py``.
"""

import os
import sys
import time

import numpy as np
import pytest

from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.resilience import (
    EpochLedger as JEpochLedger,
)
from spark_text_clustering_tpu.resilience import (
    FencedEpochError as JFencedEpochError,
)
from spark_text_clustering_tpu.resilience import supervisor as jsup
from spark_text_clustering_tpu_torch.resilience import (
    EpochLedger,
    FencedEpochError,
    ResilienceError,
    RetryGiveUp,
    RetryPolicy,
    configure_lease_deadline,
    faultinject,
    retry_call,
)
from spark_text_clustering_tpu_torch.resilience import supervisor as tsup
from spark_text_clustering_tpu_torch.resilience.supervisor import (
    FleetFence,
    FleetLedger,
    FleetSupervisor,
    WorkerLease,
    lease_path,
    partition_of,
    read_lease,
    worker_dir,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    configure_lease_deadline(None)
    jtelemetry.configure(None)
    yield
    faultinject.reset()
    configure_lease_deadline(None)
    jtelemetry.shutdown()
    jtelemetry.get_registry().reset()


# ---------------------------------------------------------------------------
# Partition, fleet ledger, fence
# ---------------------------------------------------------------------------
class TestPartition:
    def test_deterministic_and_complete(self):
        names = [f"doc{i:02d}.txt" for i in range(40)]
        for count in (1, 2, 3, 5):
            owners = [partition_of(n, count) for n in names]
            assert owners == [partition_of(n, count) for n in names]
            assert all(0 <= o < count for o in owners)
            # every worker owns something
            assert len(set(owners)) == count

    def test_keyed_on_basename(self):
        assert partition_of("/a/b/doc.txt", 3) == partition_of(
            "/x/doc.txt", 3
        )

    def test_equal_in_both_packages(self):
        names = [f"/w/doc{i:03d}.txt" for i in range(200)] + [
            "Ünïcode book.txt", "a", "plain.md"]
        for count in (1, 2, 3, 4, 7, 8):
            assert [partition_of(n, count) for n in names] == [
                jsup.partition_of(n, count) for n in names]

    def test_file_source_partition_matches_jax(self, tmp_path):
        """``FileStreamSource(partition=)`` emits the worker's files, the
        same ones the JAX package's source emits, and together the
        workers emit every file once."""
        from spark_text_clustering_tpu.streaming import (
            FileStreamSource as JSource,
        )
        from spark_text_clustering_tpu_torch.streaming import (
            FileStreamSource,
        )

        for i in range(12):
            (tmp_path / f"doc{i:02d}.txt").write_text(f"doc {i}")
        seen = []
        for idx in range(3):
            got = FileStreamSource(str(tmp_path), partition=(idx, 3)).poll()
            want = JSource(str(tmp_path), partition=(idx, 3)).poll()
            assert sorted(got.names) == sorted(want.names)
            assert all(partition_of(n, 3) == idx for n in got.names)
            seen += got.names
        assert sorted(seen) == sorted(str(p) for p in tmp_path.iterdir())


class TestFleetLedger:
    def test_append_and_current(self, tmp_path):
        fl = FleetLedger(str(tmp_path))
        assert fl.current() is None
        fl.append(kind="spawn", generation=0, worker_count=2,
                  spawn_ids={0: 0, 1: 1})
        fl.append(kind="resize", generation=1, worker_count=3,
                  spawn_ids={0: 2, 1: 3, 2: 4})
        cur = fl.current()
        assert cur["generation"] == 1 and cur["worker_count"] == 3
        assert cur["spawn_ids"] == {"0": 2, "1": 3, "2": 4}

    def test_torn_tail_tolerated(self, tmp_path):
        fl = FleetLedger(str(tmp_path))
        fl.append(kind="spawn", generation=0, worker_count=1,
                  spawn_ids={0: 0})
        with open(fl.path, "a") as f:
            f.write('{"kind": "resize", "torn mid-ap')
        assert FleetLedger(str(tmp_path)).current()["generation"] == 0

    def test_checksum_mismatch_before_the_tail_raises(self, tmp_path):
        fl = FleetLedger(str(tmp_path))
        for g in range(2):
            fl.append(kind="spawn", generation=g, worker_count=1,
                      spawn_ids={0: g})
        lines = open(fl.path).read().splitlines()
        lines[0] = lines[0].replace('"generation": 0', '"generation": 7')
        open(fl.path, "w").write("\n".join(lines) + "\n")
        for mod in (tsup, jsup):
            with pytest.raises(Exception, match="checksum"):
                mod.FleetLedger(str(tmp_path)).records()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_written_by_either_reads_in_the_other(self, tmp_path, writer):
        """A fleet.jsonl either package appends reads back in both with
        the same records and checksums, a resume record included."""
        mod = tsup if writer == "port" else jsup
        fl = mod.FleetLedger(str(tmp_path))
        fl.append(kind="spawn", generation=0, worker_count=2,
                  spawn_ids={0: 0, 1: 1})
        fl.append(kind="respawn", generation=0, worker_count=2,
                  spawn_ids={0: 2, 1: 1}, worker=0, cause="exit_137")
        fl.append(kind="resize", generation=1, worker_count=3,
                  spawn_ids={0: 3, 1: 4, 2: 5}, why="plan")
        port = FleetLedger(str(tmp_path)).records()
        jax = jsup.FleetLedger(str(tmp_path)).records()
        assert port == jax and len(port) == 3
        assert [r["checksum"] for r in port] == [
            r["checksum"] for r in jax]
        assert FleetLedger(str(tmp_path)).current() == \
            jsup.FleetLedger(str(tmp_path)).current()


class TestFence:
    def _fleet(self, tmp_path):
        fl = FleetLedger(str(tmp_path))
        fl.append(kind="spawn", generation=0, worker_count=2,
                  spawn_ids={0: 0, 1: 1})
        return fl

    def test_valid_token_passes(self, tmp_path):
        self._fleet(tmp_path)
        fence = FleetFence(str(tmp_path), 0, 0, 0)
        led = EpochLedger(worker_dir(str(tmp_path), 0), fence=fence)
        led.begin(0, kind="stream-score", sources=["a"], payloads=[])
        led.commit(0, kind="stream-score", sources=["a"])
        assert led.last_committed() == 0
        rec = led.records()[-1]
        assert (rec["worker"], rec["generation"], rec["spawn_id"]) == (
            0, 0, 0)

    def test_superseded_spawn_id_refused_typed(self, tmp_path):
        """The zombie: a respawn bumped worker 0's spawn id; the old
        incarnation's next ledger write raises FencedEpochError."""
        fl = self._fleet(tmp_path)
        zombie = FleetFence(str(tmp_path), 0, 0, 0)
        led = EpochLedger(worker_dir(str(tmp_path), 0), fence=zombie)
        led.begin(0, kind="stream-score", sources=["a"], payloads=[])
        fl.append(kind="respawn", generation=0, worker_count=2,
                  spawn_ids={0: 2, 1: 1})
        with pytest.raises(FencedEpochError, match="superseded"):
            led.commit(0, kind="stream-score", sources=["a"])
        assert led.last_committed() == -1

    def test_resize_generation_fences_all_old_tokens(self, tmp_path):
        fl = self._fleet(tmp_path)
        fl.append(kind="resize", generation=1, worker_count=3,
                  spawn_ids={0: 2, 1: 3, 2: 4})
        old = FleetFence(str(tmp_path), 0, 1, 1)
        led = EpochLedger(worker_dir(str(tmp_path), 1), fence=old)
        with pytest.raises(FencedEpochError):
            led.begin(0, kind="stream-score", sources=[], payloads=[])
        new = FleetFence(str(tmp_path), 1, 1, 3)
        led2 = EpochLedger(worker_dir(str(tmp_path), 1), fence=new)
        led2.begin(0, kind="stream-score", sources=[], payloads=[])

    def test_staged_shard_refused_under_stale_fence(self, tmp_path):
        fl = self._fleet(tmp_path)
        fence = FleetFence(str(tmp_path), 0, 0, 0)
        led = EpochLedger(worker_dir(str(tmp_path), 0), fence=fence)
        led.begin(0, kind="stream-train", sources=["a"],
                  payloads=["stream_state-e000000-p0.npz"])
        fl.append(kind="respawn", generation=0, worker_count=2,
                  spawn_ids={0: 9, 1: 1})
        with pytest.raises(FencedEpochError):
            led.stage_shard(
                0, 0, 1, cols=(0, 4), step=1,
                lam=np.ones((2, 4), np.float32),
            )

    def test_no_fleet_record_is_standalone(self, tmp_path):
        FleetFence(str(tmp_path), 3, 1, 7).verify()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_verdicts_equal_in_both_packages(self, tmp_path, writer):
        """Tokens checked against a fleet ledger either package wrote:
        both packages' ``FleetFence.verify`` accept and refuse alike."""
        mod = tsup if writer == "port" else jsup
        fl = mod.FleetLedger(str(tmp_path))
        fl.append(kind="spawn", generation=0, worker_count=2,
                  spawn_ids={0: 0, 1: 1})
        fl.append(kind="respawn", generation=0, worker_count=2,
                  spawn_ids={0: 2, 1: 1})
        tokens = [(0, 0, 0), (0, 0, 2), (0, 1, 1), (0, 1, 3), (1, 0, 2),
                  (0, 2, 0)]

        def verdict(fence_cls, refused, token):
            try:
                fence_cls(str(tmp_path), *token).verify()
                return "ok"
            except refused:
                return "fenced"

        port = [verdict(FleetFence, FencedEpochError, t) for t in tokens]
        jax = [verdict(jsup.FleetFence, JFencedEpochError, t)
               for t in tokens]
        assert port == jax == ["fenced", "ok", "ok", "fenced", "fenced",
                               "fenced"]


# ---------------------------------------------------------------------------
# Lease
# ---------------------------------------------------------------------------
class TestWorkerLease:
    def test_beat_rate_limited_and_readable(self, tmp_path):
        lp = str(tmp_path / "lease.json")
        lease = WorkerLease(lp, interval=10.0, worker_index=1,
                            generation=2, spawn_id=3)
        assert lease.beat(queue_depth=5, epoch=7) is True
        assert lease.beat(queue_depth=9) is False       # rate limited
        got = read_lease(lp)
        assert got["worker"] == 1 and got["generation"] == 2
        assert got["spawn_id"] == 3 and got["queue_depth"] == 5
        assert got["epoch"] == 7 and got["pid"] == os.getpid()
        assert lease.beat(queue_depth=9, force=True) is True
        assert read_lease(lp)["queue_depth"] == 9

    def test_mark_done_terminal_state(self, tmp_path):
        lp = str(tmp_path / "lease.json")
        lease = WorkerLease(lp, interval=10.0)
        lease.mark_done("preempted", epoch=4)
        got = read_lease(lp)
        assert got["done"] is True and got["reason"] == "preempted"
        assert got["epoch"] == 4

    def test_heartbeat_fault_site_fires(self, tmp_path):
        faultinject.configure("worker.heartbeat:ioerror@1.0")
        lease = WorkerLease(str(tmp_path / "l.json"), interval=0.0)
        with pytest.raises(RetryGiveUp):
            lease.beat(force=True)
        # mark_done swallows a failing write: the exit code still tells
        lease.mark_done("idle")
        assert read_lease(str(tmp_path / "l.json")) is None

    def test_torn_lease_reads_as_absent(self, tmp_path):
        lp = tmp_path / "lease.json"
        lp.write_text('{"pid": 1, "torn')
        assert read_lease(str(lp)) is None
        assert read_lease(str(tmp_path / "missing.json")) is None

    def test_heartbeat_callback_forwards_queue_depth(self, tmp_path):
        lp = str(tmp_path / "lease.json")
        cb = WorkerLease(lp, interval=0.0).heartbeat_callback()
        cb(11)
        assert read_lease(lp)["queue_depth"] == 11

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_lease_reads_in_both_packages(self, tmp_path, writer):
        mod = tsup if writer == "port" else jsup
        lp = mod.lease_path(str(tmp_path), 2)
        assert lp == lease_path(str(tmp_path), 2) == jsup.lease_path(
            str(tmp_path), 2)
        lease = mod.WorkerLease(lp, worker_index=2, generation=1,
                                spawn_id=5)
        lease.beat(queue_depth=3, epoch=4, force=True)
        port, jax = read_lease(lp), jsup.read_lease(lp)
        assert port == jax
        for key, val in (("worker", 2), ("generation", 1), ("spawn_id", 5),
                         ("queue_depth", 3), ("epoch", 4)):
            assert port[key] == val
        lease.mark_done("fenced")
        assert read_lease(lp) == jsup.read_lease(lp)
        assert read_lease(lp)["reason"] == "fenced"


# ---------------------------------------------------------------------------
# Fleet-wide ledger reads
# ---------------------------------------------------------------------------
def test_fleet_committed_reads_agree_with_jax(tmp_path):
    """One fleet dir with worker ledgers written by both packages (and a
    stray dir that is no worker's): the committed-source union and the
    committed-epoch count are the same in both."""
    fleet = str(tmp_path)
    for w, led_cls, n in ((0, EpochLedger, 3), (1, JEpochLedger, 2),
                          (2, EpochLedger, 0)):
        led = led_cls(worker_dir(fleet, w))
        for e in range(n):
            src = [f"/watch/w{w}-doc{e}.txt"]
            led.begin(e, kind="stream-score", sources=src, payloads=[])
            led.commit(e, kind="stream-score", sources=src)
    os.makedirs(os.path.join(fleet, "wxyz"))
    os.makedirs(os.path.join(fleet, "leases"))
    got = tsup.fleet_committed_sources(fleet)
    assert got == jsup.fleet_committed_sources(fleet)
    assert len(got) == 5
    assert tsup.fleet_committed_epochs(fleet) == \
        jsup.fleet_committed_epochs(fleet) == 5
    assert tsup.fleet_committed_sources(str(tmp_path / "none")) == set()


# ---------------------------------------------------------------------------
# Retry deadline budget
# ---------------------------------------------------------------------------
class TestRetryDeadline:
    def _boom(self):
        raise OSError("injected")

    def test_deadline_seconds_bounds_the_loop(self):
        t0 = time.monotonic()
        with pytest.raises(RetryGiveUp) as ei:
            retry_call(
                self._boom, site="dl",
                policy=RetryPolicy(
                    attempts=1000, base_delay=0.02, max_delay=0.05,
                    deadline_seconds=0.2,
                ),
            )
        assert ei.value.deadline_exceeded
        assert time.monotonic() - t0 < 2.0

    def test_lease_cap_bounds_every_policy(self):
        configure_lease_deadline(0.15)
        with pytest.raises(RetryGiveUp) as ei:
            retry_call(
                self._boom, site="dl2",
                policy=RetryPolicy(attempts=1000, base_delay=0.02,
                                   max_delay=0.05),
            )
        assert ei.value.deadline_exceeded

    def test_attempt_exhaustion_is_not_a_deadline_giveup(self):
        with pytest.raises(RetryGiveUp) as ei:
            retry_call(
                self._boom, site="dl3",
                policy=RetryPolicy(attempts=2, base_delay=0.0),
            )
        assert not ei.value.deadline_exceeded

    def test_zero_budget_raises_typed_not_assert(self):
        with pytest.raises(RetryGiveUp) as ei:
            retry_call(
                self._boom, site="dl4",
                policy=RetryPolicy(attempts=3, deadline_seconds=0.0),
            )
        assert ei.value.deadline_exceeded


# ---------------------------------------------------------------------------
# Supervisor loop against stub workers (no torch, no jax)
# ---------------------------------------------------------------------------
STUB = r"""
import json, os, signal, sys, time

lease, gen, sid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mode = os.environ.get("STUB_MODE", "clean")
beats = int(os.environ.get("STUB_BEATS", "4"))
depth = int(os.environ.get("STUB_DEPTH", "0"))
signal.signal(signal.SIGTERM, lambda s, f: None)   # ignore drains

def write(**kw):
    payload = {"pid": os.getpid(), "generation": gen, "spawn_id": sid,
               "ts": time.time(), "queue_depth": depth, **kw}
    tmp = lease + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, lease)

write()
if mode == "hang" and sid < 10:
    time.sleep(3600)
if mode == "preempt" and sid < 10:
    write(done=True, reason="preempted")
    sys.exit(0)
if mode == "crash" and sid < 10:
    os._exit(137)
for _ in range(beats):
    time.sleep(0.08)
    write()
write(done=True, reason="idle")
"""


def _stub_argv_builder(tmp_path, fleet):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)

    def build(index, count, generation, spawn_id):
        return [sys.executable, str(stub), lease_path(fleet, index),
                str(generation), str(spawn_id)]

    return build


def _sup(tmp_path, fleet, mode, **kw):
    env = {
        k: v for k, v in os.environ.items()
        if k not in (faultinject.ENV_SPEC, faultinject.ENV_SEED)
    }
    env["STUB_MODE"] = mode
    env.update(kw.pop("stub_env", {}))
    base = dict(
        workers=2, lease_timeout=1.0, grace_seconds=0.4,
        sweep_interval=0.1, startup_grace_seconds=10.0, env=env,
    )
    base.update(kw)
    return FleetSupervisor(
        fleet, _stub_argv_builder(tmp_path, fleet), **base
    )


class TestSupervisorStubFleet:
    def test_clean_fleet_converges(self, tmp_path):
        fleet = str(tmp_path / "fleet")
        rep = _sup(tmp_path, fleet, "clean").run()
        assert rep.converged and rep.spawns == 2
        assert rep.respawns == 0 and rep.lease_expiries == 0
        cur = FleetLedger(fleet).current()
        assert cur["kind"] == "spawn" and cur["worker_count"] == 2

    def test_hung_worker_escalates_and_respawns(self, tmp_path):
        """The full ladder: a worker that stops heartbeating (alive,
        SIGTERM-deaf) is detected by lease expiry, SIGKILLed, recovered
        and respawned under a fresh spawn id; spawn ids >= 10 run the stub
        clean, so only the first incarnation hangs."""
        fleet = str(tmp_path / "fleet")
        sup = _sup(tmp_path, fleet, "hang")
        sup._next_spawn_id = 9      # spawn ids 9,10 -> only w0 hangs
        rep = sup.run()
        assert rep.converged
        assert rep.lease_expiries == 1 and rep.respawns == 1
        assert rep.spawns == 3
        # the respawn superseded the hung incarnation in the fence log
        cur = FleetLedger(fleet).current()
        assert cur["kind"] == "respawn"

    def test_crashed_worker_respawns(self, tmp_path):
        fleet = str(tmp_path / "fleet")
        sup = _sup(tmp_path, fleet, "crash")
        sup._next_spawn_id = 9
        rep = sup.run()
        assert rep.converged and rep.crashes == 1 and rep.respawns == 1

    def test_external_preemption_survived(self, tmp_path):
        """A worker that drains after an external SIGTERM (done lease,
        reason preempted, the supervisor never asked) is respawned and
        the survival counted."""
        fleet = str(tmp_path / "fleet")
        sup = _sup(tmp_path, fleet, "preempt")
        sup._next_spawn_id = 9
        rep = sup.run()
        assert rep.converged and rep.preemptions == 1
        assert rep.respawns == 1

    def test_queue_depth_scale_out(self, tmp_path):
        fleet = str(tmp_path / "fleet")
        rep = _sup(
            tmp_path, fleet, "clean",
            stub_env={"STUB_DEPTH": "8", "STUB_BEATS": "12"},
            scale_out_depth=10, scale_out_sweeps=2, max_workers=3,
        ).run()
        assert rep.converged and rep.resizes >= 1
        assert rep.resize_history[0] == 3
        cur = FleetLedger(fleet).current()
        assert cur["worker_count"] == 3 and cur["generation"] >= 1

    def test_respawn_budget_aborts_loudly(self, tmp_path):
        fleet = str(tmp_path / "fleet")
        sup = _sup(tmp_path, fleet, "crash", max_respawns=2, workers=1)
        # every incarnation crashes: spawn ids stay < 10
        with pytest.raises(ResilienceError, match="respawn budget"):
            sup.run()
        # no orphan processes left behind
        for w in sup._procs.values():
            assert w.proc.poll() is not None

    def test_resumed_supervision_bumps_the_generation(self, tmp_path):
        """A supervisor started on a fleet dir with records (here the JAX
        package's) adopts its topology, records ``resume`` one generation
        on, and issues spawn ids past the newest one."""
        fleet = str(tmp_path / "fleet")
        jsup.FleetLedger(fleet).append(
            kind="resize", generation=2, worker_count=3,
            spawn_ids={0: 4, 1: 5, 2: 6})
        rep = _sup(tmp_path, fleet, "clean", workers=1).run()
        assert rep.converged and rep.spawns == 3 and rep.final_workers == 3
        for mod in (tsup, jsup):
            cur = mod.FleetLedger(fleet).current()
            assert cur["kind"] == "resume" and cur["generation"] == 3
            assert cur["spawn_ids"] == {"0": 7, "1": 8, "2": 9}

    def test_spawn_fault_site_retries(self, tmp_path):
        """``supervisor.spawn`` fires before each spawn; a transient
        failure there is retried and the fleet still converges."""
        fleet = str(tmp_path / "fleet")
        faultinject.configure("supervisor.spawn:fail@1")
        rep = _sup(tmp_path, fleet, "clean").run()
        assert rep.converged and rep.spawns == 2

    def test_kill_fault_site_fires_before_sigkill(self, tmp_path):
        """``worker.kill`` fires where the ladder escalates to SIGKILL:
        an injected failure there aborts the sweep (and the finally
        block still reaps every worker)."""
        fleet = str(tmp_path / "fleet")
        faultinject.configure("worker.kill:fail@1")
        sup = _sup(tmp_path, fleet, "hang")
        sup._next_spawn_id = 9
        with pytest.raises(OSError, match="worker.kill"):
            sup.run()
        for w in sup._procs.values():
            assert w.proc.poll() is not None
