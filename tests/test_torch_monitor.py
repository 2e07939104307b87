"""The port's live alerting (``telemetry.alerts``, the ``monitor`` verb), the
supervisor's actions file and the serve fleet's autoscaler, held against
the JAX package's on the CPU: each class of the JAX package's
``tests/test_monitor.py`` driven through both packages on the same inputs.

Tolerances: signal values, alert logs, actions files, acks and fence
records equal (the same float64 arithmetic on the same events under one
fake clock, so ``alerts.jsonl`` is equal byte for byte); drift distances
within 1e-12; ``monitor --once`` exit codes equal and its output equal with
the numbers and paths masked.  Stub workers are plain Python, no torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.resilience import supervisor as jsup
from spark_text_clustering_tpu.resilience.ledger import EpochLedger
from spark_text_clustering_tpu.telemetry import alerts as jalerts
from spark_text_clustering_tpu.telemetry import metrics_cli as jmetrics
from spark_text_clustering_tpu.telemetry import queueing as jqueueing
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.resilience import supervisor as tsup
from spark_text_clustering_tpu_torch.telemetry import alerts as talerts
from spark_text_clustering_tpu_torch.telemetry import metrics_cli as tmetrics
from spark_text_clustering_tpu_torch.telemetry import queueing as tqueueing

PKGS = {
    "jax": SimpleNamespace(al=jalerts, tel=jtelemetry, fault=jfault,
                           sup=jsup, metrics=jmetrics, q=jqueueing),
    "port": SimpleNamespace(al=talerts, tel=telemetry, fault=faultinject,
                            sup=tsup, metrics=tmetrics, q=tqueueing),
}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.tel.shutdown()
        p.tel.get_registry().reset()
        p.fault.reset()
        p.al._firing_cache.clear()
    yield
    for p in PKGS.values():
        p.tel.shutdown()
        p.tel.get_registry().reset()
        p.fault.reset()


@pytest.fixture()
def fixed_time(monkeypatch):
    """``time.time`` pinned, so the actions' ``ts`` fields agree."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def both(fn, *args):
    """``fn(pkg, *args)`` for each package: {"jax": ..., "port": ...}."""
    return {name: fn(p, *args) for name, p in PKGS.items()}


def same(fn, *args):
    """``fn`` through both packages; the port's result after checking it
    equals the JAX package's."""
    got = both(fn, *args)
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# signals: every agg, by, reduce and where over one seeded window
# ---------------------------------------------------------------------------
def _window(seed=0, n=80):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = float(np.round(rng.uniform(0.0, 100.0), 3))
        e = {"event": str(rng.choice(["m", "lease", "other"])), "ts": ts,
             "worker": int(rng.integers(0, 3)),
             "v": float(np.round(rng.normal(5.0, 3.0), 4)),
             "done": bool(rng.integers(0, 2)),
             "digest": f"d{int(rng.integers(0, 5))}"}
        if i % 7 == 0:
            e["v"] = "not a number"
        elif i % 11 == 0:
            e["v"] = True
        elif i % 13 == 0:
            e["v"] = float("nan")
        out.append((ts, e))
    return out


@pytest.mark.parametrize("agg", jalerts.AGGS)
def test_signals_agree(agg):
    events = _window()
    for event in ("m", "lease"):
        for by in (None, "worker"):
            for red in (None, *jalerts.REDUCES):
                for where in (None, {"done": True}):
                    for window in (30.0, 300.0):
                        sig = {"event": event, "agg": agg,
                               "window_seconds": window,
                               "field": "digest" if agg == "distinct"
                               else "v"}
                        if by:
                            sig["by"] = by
                        if red:
                            sig["reduce"] = red
                        if where:
                            sig["where"] = where
                        got = same(lambda p: p.al.eval_signal(
                            dict(sig), events, 101.0))
                        assert got or where or window == 30.0


# ---------------------------------------------------------------------------
# rule validation: the same exception type and message
# ---------------------------------------------------------------------------
BAD_RULES = {
    "kind": lambda al: al.AlertRule(name="r", kind="nope"),
    "op": lambda al: al.AlertRule(name="r", op="!=", signal={"event": "m"}),
    "agg": lambda al: al.AlertRule(
        name="r", signal={"event": "m", "agg": "median"}),
    "reduce": lambda al: al.AlertRule(
        name="r", signal={"event": "m", "reduce": "median"}),
    "no_signal": lambda al: al.AlertRule(name="r", kind="threshold"),
    "divergence_by": lambda al: al.AlertRule(
        name="r", kind="divergence", signal={"event": "m"}),
    "drift_metric": lambda al: al.AlertRule(
        name="r", kind="drift", metric="js"),
    "action": lambda al: al.AlertRule(
        name="r", signal={"event": "m"}, action={"kind": "explode"}),
    "unknown_field": lambda al: al.rule_from_dict(
        {"name": "r", "threshold": 3}),
    "no_name": lambda al: al.rule_from_dict({"kind": "threshold"}),
    "duplicate": lambda al: al.AlertEngine(
        [al.AlertRule(name="r", signal={"event": "m"})] * 2),
    "builtin": lambda al: al.builtin_rules(["nope"]),
}


@pytest.mark.parametrize("case", sorted(BAD_RULES))
def test_rule_validation_raises_alike(case):
    def raised(p):
        with pytest.raises(Exception) as info:
            BAD_RULES[case](p.al)
        return type(info.value).__name__, str(info.value)

    assert same(raised)[0] == "ValueError"


def test_builtin_rules_and_schemas_agree():
    assert talerts.BUILTIN_RULES == jalerts.BUILTIN_RULES
    assert (talerts.ALERTS_SCHEMA, talerts.ACTIONS_SCHEMA,
            talerts.ALERTS_LOG_NAME) == (jalerts.ALERTS_SCHEMA,
                                         jalerts.ACTIONS_SCHEMA,
                                         jalerts.ALERTS_LOG_NAME)
    rules = same(lambda p: [dataclasses.asdict(r)
                            for r in p.al.builtin_rules()])
    assert {r["kind"] for r in rules} == set(jalerts.RULE_KINDS)
    # a burn_rate rule's unset value reads as the defaults' multiplier
    assert same(lambda p: p.al.AlertRule(name="b", kind="burn_rate").value
                ) == 1.0


# ---------------------------------------------------------------------------
# the state machine, absence and divergence under one fake clock
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _age_rule(al, **kw):
    base = dict(
        name="stale", kind="threshold",
        signal={"event": "lease", "field": "age", "agg": "last",
                "by": "worker", "window_seconds": 30.0},
        op=">", value=5.0, for_seconds=1.0, resolve_seconds=2.0)
    base.update(kw)
    return al.AlertRule(**base)


def _feed(eng, clock, age, worker=0):
    eng._ingest([{"event": "lease", "ts": clock.t, "worker": worker,
                  "age": age}], clock.t)
    return eng.poll(clock.t)


def _lifecycle(al, clock, log):
    eng = al.AlertEngine([_age_rule(al)], alerts_path=log, now_fn=clock)
    for step, age in ((0.0, 9.0), (1.5, 9.5), (1.0, 0.5), (2.5, 0.5)):
        clock.t += step
        _feed(eng, clock, age)
    return eng


def _flap(al, clock, log):
    eng = al.AlertEngine([_age_rule(al)], alerts_path=log, now_fn=clock)
    _feed(eng, clock, 9.0)
    clock.t += 1.5
    _feed(eng, clock, 9.0)
    for _ in range(4):
        for age in (0.1, 9.0):
            clock.t += 0.5
            _feed(eng, clock, age)
    return eng


def _pending_cancel(al, clock, log):
    eng = al.AlertEngine([_age_rule(al, for_seconds=5.0)], alerts_path=log,
                         now_fn=clock)
    for step, age in ((0.0, 9.0), (1.0, 0.1), (10.0, 0.1)):
        clock.t += step
        _feed(eng, clock, age)
    return eng


def _per_key(al, clock, log):
    eng = al.AlertEngine([_age_rule(al, for_seconds=0.0)], alerts_path=log,
                         now_fn=clock)
    eng._ingest([{"event": "lease", "ts": clock.t, "worker": w, "age": a}
                 for w, a in ((0, 9.0), (1, 0.1), (2, 6.0))], clock.t)
    eng.poll(clock.t)
    clock.t += 3.0
    _feed(eng, clock, 0.2, worker=2)
    return eng


def _absence(al, clock, log):
    rule = al.AlertRule(name="stalled", kind="absence",
                        signal={"event": "micro_batch"}, op=">",
                        value=10.0, resolve_seconds=0.0)
    eng = al.AlertEngine([rule], alerts_path=log, now_fn=clock)
    eng._ingest([{"event": "micro_batch", "ts": clock.t}], clock.t)
    eng.poll(clock.t)
    clock.t += 11.0
    eng.poll(clock.t)
    eng._ingest([{"event": "micro_batch", "ts": clock.t}], clock.t)
    eng.poll(clock.t)
    return eng


def _absence_never_seen(al, clock, log):
    rule = al.AlertRule(name="stalled", kind="absence",
                        signal={"event": "micro_batch"}, op=">", value=10.0)
    eng = al.AlertEngine([rule], alerts_path=log, now_fn=clock)
    for step in (0.0, 5.0, 6.0):
        clock.t += step
        eng.poll(clock.t)
    return eng


def _replica_down(al, clock, log):
    """The built-in ``replica_down``: keyed by worker, serve leases only;
    one replica goes quiet, then comes back."""
    (rule,) = al.builtin_rules(["replica_down"])
    eng = al.AlertEngine([rule], alerts_path=log, now_fn=clock)
    for i in range(12):
        beats = [{"event": "lease", "ts": clock.t, "worker": w,
                  "role": role}
                 for w, role in ((0, "serve"), (1, "serve"), (2, "stream"))
                 if not (w == 1 and 2 <= i < 8)]
        eng._ingest(beats, clock.t)
        eng.poll(clock.t)
        clock.t += 0.75
    return eng


def _divergence(al, clock, log):
    rule = al.AlertRule(name="fleet_skew", kind="divergence",
                        signal={"event": "lease", "field": "queue_depth",
                                "agg": "last", "by": "worker",
                                "window_seconds": 30.0},
                        op=">", value=1.0, for_seconds=0.0)
    eng = al.AlertEngine([rule], alerts_path=log, now_fn=clock)
    for depths in ((12, 1), (5, 6), (50,)):
        eng._ingest([{"event": "lease", "ts": clock.t, "worker": w,
                      "queue_depth": d} for w, d in enumerate(depths)],
                    clock.t)
        eng.poll(clock.t)
        clock.t += 40.0
    return eng


def _restart(al, clock, log):
    eng = al.AlertEngine([_age_rule(al, for_seconds=0.0)], alerts_path=log,
                         now_fn=clock)
    _feed(eng, clock, 9.0)
    clock.t += 1.0
    eng2 = al.AlertEngine([_age_rule(al, for_seconds=0.0)], alerts_path=log,
                          now_fn=clock)
    assert eng2.firing() == [("stale", "0")]
    for step, age in ((0.0, 9.5), (3.0, 0.1), (2.5, 0.1)):
        clock.t += step
        _feed(eng2, clock, age)
    return eng2


SCENARIOS = {f.__name__[1:]: f for f in (
    _lifecycle, _flap, _pending_cancel, _per_key, _absence,
    _absence_never_seen, _replica_down, _divergence, _restart)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machines_write_equal_alert_logs(tmp_path, name):
    """The same scenario through both engines under one fake clock: equal
    transitions and firing sets, and ``alerts.jsonl`` equal byte for
    byte (each package reads the other's log)."""
    def run(p):
        log = str(tmp_path / f"{p.al.__name__.split('.')[0]}.jsonl")
        eng = SCENARIOS[name](p.al, _Clock(), log)
        with open(log, "rb") as f:
            raw = f.read()
        return eng.transitions, eng.firing(), raw, log

    got = both(run)
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][0], "the scenario made no transition"
    for reader, writer in (("port", "jax"), ("jax", "port")):
        recs, torn = PKGS[reader].al.AlertLog(got[writer][3]).replay()
        assert torn == 0 and len(recs) == got[writer][2].count(b"\n")


def test_firing_alerts_and_resumed_firing_set(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p.al.__name__.split('.')[0]}.jsonl")
        log = p.al.AlertLog(path)
        seen = []
        for ts, rec in enumerate((
                dict(rule="a", key="", state="firing", value=2.0,
                     threshold=1.0),
                dict(rule="b", key="3", state="firing", value=9.0),
                dict(rule="a", key="", state="resolved"),
                dict(rule="c", key="1", state="pending", value=1.0))):
            log.append(ts=float(ts), **rec)
            p.al._firing_cache.clear()
            seen.append(p.al.firing_alerts(path))
        with open(path, "a") as f:
            f.write('{"rule": "b", "torn')
        resumed = p.al.AlertEngine(
            [p.al.AlertRule(name="b", signal={"event": "m"})],
            alerts_path=path).firing()
        return (seen, resumed, p.al.firing_alerts(str(tmp_path / "none")),
                p.al.AlertLog(path).seq)

    seen, resumed, missing, seq = same(run)
    assert [[f["rule"] for f in s] for s in seen] == [
        ["a"], ["a", "b"], ["b"], ["b"]]
    assert resumed == [("b", "3")] and missing == [] and seq == 4


def test_a_corrupt_interior_record_raises_alike(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p.al.__name__.split('.')[0]}.jsonl")
        log = p.al.AlertLog(path)
        log.append(rule="r", key="0", state="firing", ts=1.0)
        log.append(rule="r", key="0", state="resolved", ts=2.0)
        lines = open(path).read().splitlines()
        lines[0] = lines[0].replace("firing", "FIRinG")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(Exception) as info:
            p.al.AlertLog(path).replay()
        p.al._firing_cache.clear()
        return type(info.value).__name__, p.al.firing_alerts(path)

    assert same(run) == ("CorruptArtifactError", [])


# ---------------------------------------------------------------------------
# the topic-drift probe on one ledger
# ---------------------------------------------------------------------------
K, V = 3, 32


def _commit_lambda(ckpt, epoch, lam):
    led = EpochLedger(ckpt)
    led.begin(epoch, kind="stream-train", sources=[f"doc-{epoch:03d}"],
              payloads=[])
    spec = led.stage_shard(epoch, 0, 1, cols=(0, lam.shape[1]), step=epoch,
                           lam=np.asarray(lam, np.float32))
    led.commit(epoch, kind="stream-train", sources=[f"doc-{epoch:03d}"],
               shards=[spec], process_count=1)


def test_topic_distance_agrees():
    rng = np.random.default_rng(0)
    a = rng.random((K, V)) + 0.05
    b = a.copy()
    b[1] = rng.random(V) + 0.05
    for x, y in ((a, a[[2, 0, 1]]), (a, b), (b, a)):
        want = jalerts.topic_distance(x, y)
        got = talerts.topic_distance(x, y)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_drift_probes_agree_on_one_ledger(tmp_path):
    """Both engines watch one ledger with epochs committed between their
    polls: the same transitions, kl and hellinger within 1e-12, and a
    bit-rotted shard skipped by both."""
    ckpt = str(tmp_path / "ckpt")
    rng = np.random.default_rng(1)
    lam = (rng.random((K, V)) + 0.05).astype(np.float32)
    moved = lam.copy()
    moved[0] = (rng.random(V) + 0.05).astype(np.float32)
    clock = _Clock()
    engines = {name: p.al.AlertEngine(
        [p.al.AlertRule(name="topic_drift", kind="drift", metric="kl",
                        op=">", value=0.05, ledger_dir=ckpt)],
        now_fn=clock) for name, p in PKGS.items()}
    for p in PKGS.values():
        p.tel.configure(None)
    seen = {name: [] for name in PKGS}
    for epoch, lam_e in enumerate((lam, lam[[1, 2, 0]], moved,
                                   moved[[2, 1, 0]])):
        _commit_lambda(ckpt, epoch, lam_e)
        clock.t += 1.0
        for name, eng in engines.items():
            trs = eng.poll(clock.t)
            probe = eng._probes[0][1]
            seen[name].append(([(t["state"], t["key"]) for t in trs],
                               probe.kl, probe.hellinger, probe.last_epoch))
    for (jt, jkl, jh, je), (tt, tkl, th, te) in zip(seen["jax"],
                                                    seen["port"]):
        assert (tt, te) == (jt, je)
        if jkl is None:
            assert tkl is None and th is None
        else:
            assert abs(tkl - jkl) <= 1e-12 and abs(th - jh) <= 1e-12
    assert [s[0] for s in seen["port"]] == [[], [], [("firing", "ckpt")],
                                            [("resolved", "ckpt")]]
    # a bit-rotted newest shard is skipped by both probes
    _commit_lambda(ckpt, 4, lam)
    rec = [r for r in EpochLedger(ckpt).records() if r.get("shards")][-1]
    with open(os.path.join(ckpt, rec["shards"][0]["file"]), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    assert same(lambda p: (p.al.DriftProbe(ckpt).poll(0.0),
                           engines["port" if p.al is talerts else "jax"]
                           ._probes[0][1].poll(9.0))) == (None, None)


# ---------------------------------------------------------------------------
# actions: ids across a restart, one action per firing episode
# ---------------------------------------------------------------------------
def _files(tmp_path, p, *names):
    tag = p.al.__name__.split(".")[0]
    return [str(tmp_path / f"{tag}_{n}") for n in names]


def test_action_ids_survive_a_restart(tmp_path, fixed_time):
    def run(p):
        (path,) = _files(tmp_path, p, "actions.json")
        em = p.al.ActionEmitter(path)
        em.emit("scale_out", alert="queue_depth", key="", value=9.0)
        em.flush()
        flushed_again = em.flush()
        em2 = p.al.ActionEmitter(path)
        em2.emit("drain", alert="worker_stale", key="1", value=20.0,
                 worker=1)
        em2.flush()
        with open(path) as f:
            return f.read(), flushed_again, p.al.read_actions(path)

    text, again, doc = same(run)
    assert not again and [a["id"] for a in doc["actions"]] == [0, 1]


def test_torn_or_odd_actions_files_read_empty(tmp_path):
    bodies = ['{"actions": [{"id"', '[1, 2]', '{"actions": 3}', '']
    for i, body in enumerate(bodies):
        path = tmp_path / f"a{i}.json"
        path.write_text(body)
        assert same(lambda p: p.al.read_actions(str(path))) == {
            "actions": []}
    assert same(lambda p: p.al.read_actions(None)) == {"actions": []}


def test_one_action_per_firing_episode(tmp_path, fixed_time):
    def run(p):
        actions, log = _files(tmp_path, p, "actions.json", "alerts.jsonl")
        clock = _Clock()
        rule = _age_rule(p.al, for_seconds=0.0, resolve_seconds=0.0,
                         action={"kind": "drain"})
        eng = p.al.AlertEngine([rule], actions_path=actions,
                               alerts_path=log, now_fn=clock)
        for age in (9.0, 9.0, 9.0, 0.1, 9.0, 9.0):
            _feed(eng, clock, age)
            clock.t += 1.0
        with open(actions) as f, open(log) as g:
            return f.read(), g.read()

    text, _ = same(run)
    acts = json.loads(text)["actions"]
    assert [(a["id"], a["kind"], a["worker"], a["alert"]) for a in acts] == [
        (0, "drain", 0, "stale"), (1, "drain", 0, "stale")]


# ---------------------------------------------------------------------------
# the supervisors apply the actions file (stub workers)
# ---------------------------------------------------------------------------
STUB = r"""
import json, os, signal, sys, time

lease, gen, sid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
beats = int(os.environ.get("STUB_BEATS", "6"))
signal.signal(signal.SIGTERM, lambda s, f: None)   # ignore drains

def write(**kw):
    payload = {"pid": os.getpid(), "generation": gen, "spawn_id": sid,
               "ts": time.time(), "queue_depth": 0,
               "worker": int(os.path.basename(lease)[1:4]), **kw}
    tmp = lease + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, lease)

write()
for _ in range(beats):
    time.sleep(0.08)
    write()
write(done=True, reason="idle")
"""


def _stub_supervisor(tmp_path, p, fleet, actions_file, beats, **kw):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)

    def build(index, count, generation, spawn_id):
        return [sys.executable, str(stub), p.sup.lease_path(fleet, index),
                str(generation), str(spawn_id)]

    env = {k: v for k, v in os.environ.items()
           if k not in (p.fault.ENV_SPEC, p.fault.ENV_SEED)}
    env["STUB_BEATS"] = str(beats)
    base = dict(workers=1, max_workers=2, lease_timeout=2.0,
                grace_seconds=0.4, sweep_interval=0.1,
                startup_grace_seconds=10.0, env=env,
                actions_file=actions_file)
    base.update(kw)
    return p.sup.FleetSupervisor(fleet, build, **base)


ACTION_CASES = {
    # (the action, workers, beats, runs of the same fleet)
    "scale_out": ({"id": 0, "kind": "scale_out", "alert": "queue_depth",
                   "key": "", "value": 9.0}, 1, 10, 1),
    "acked_never_reapplied": ({"id": 0, "kind": "scale_out",
                               "alert": "queue_depth", "key": "",
                               "value": 9.0}, 1, 10, 2),
    "drain": ({"id": 0, "kind": "drain", "alert": "worker_stale",
               "key": "0", "value": 30.0, "worker": 0}, 2, 12, 1),
    "clamped_but_acked": ({"id": 0, "kind": "scale_out",
                           "alert": "queue_depth", "key": "",
                           "value": 9.0}, 2, 6, 1),
}


@pytest.mark.parametrize("case", sorted(ACTION_CASES))
def test_supervisors_apply_actions_alike(tmp_path, case):
    """One actions file through each package's supervisor: equal fence
    records, acks, reports and ``fleet.actions_applied`` counts."""
    action, workers, beats, runs = ACTION_CASES[case]

    def run(p):
        fleet, actions = _files(tmp_path, p, "fleet", "actions.json")
        with open(actions, "w") as f:
            json.dump({"schema": 1, "actions": [action]}, f)
        p.tel.configure(None)
        reports = []
        for i in range(runs):
            rep = _stub_supervisor(tmp_path, p, fleet, actions,
                                   beats if i == 0 else 6,
                                   workers=workers).run()
            reports.append((rep.converged, rep.spawns, rep.respawns,
                            rep.resizes, rep.resize_history))
        records = [(r["kind"], r["generation"], r["worker_count"],
                    {int(i): s for i, s in r["spawn_ids"].items()},
                    r.get("why"))
                   for r in p.sup.FleetLedger(fleet).records()]
        with open(actions + ".ack") as f:
            ack = json.load(f)
        applied = p.tel.get_registry().counter(
            "fleet.actions_applied").value
        return records, reports, ack, applied

    records, reports, ack, applied = same(run)
    assert ack == {"last_id": 0} and applied == 1
    assert all(r[0] for r in reports)
    if case in ("scale_out", "acked_never_reapplied"):
        assert reports[0][3:] == (1, [2])
        assert [r[4] for r in records if r[0] == "resize"] == [
            "alert_queue_depth"]
    if case == "acked_never_reapplied":
        assert reports[1][3] == 0
    if case == "drain":
        assert reports[0][1:4] == (3, 1, 0)
    if case == "clamped_but_acked":
        assert reports[0][3] == 0


# ---------------------------------------------------------------------------
# the fleet's leases as pseudo-events
# ---------------------------------------------------------------------------
def test_lease_events_agree(tmp_path):
    fleet = str(tmp_path / "fleet")
    os.makedirs(os.path.join(fleet, "leases"))
    leases = {0: {"worker": 0, "ts": 92.5, "queue_depth": 3},
              1: {"worker": 1, "ts": 99.0, "role": "serve",
                  "state": "ready", "generation": 2},
              2: {"worker": 2, "ts": 99.0, "done": True, "reason": "idle"}}
    for i, lease in leases.items():
        with open(tsup.lease_path(fleet, i), "w") as f:
            json.dump(lease, f)
    with open(os.path.join(fleet, "leases", "w003.json"), "w") as f:
        f.write('{"torn')

    def run(p):
        rule = _age_rule(p.al, for_seconds=0.0, resolve_seconds=2.0)
        eng = p.al.AlertEngine([rule], fleet_dir=fleet)
        out = [eng._lease_events(100.0)]
        out.append([(t["state"], t["key"], t["value"])
                    for t in eng.poll(100.0)])
        for i in (0, 1):
            with open(tsup.lease_path(fleet, i), "w") as f:
                json.dump(dict(leases[i], done=True), f)
        out += [eng.poll(140.0), [(t["state"], t["key"])
                                  for t in eng.poll(143.0)]]
        for i in (0, 1):
            with open(tsup.lease_path(fleet, i), "w") as f:
                json.dump(leases[i], f)
        return out

    events, fired, quiet, resolved = same(run)
    assert [e["worker"] for e in events] == [0, 1]
    assert fired == [("firing", "0", 7.5)] and quiet == []
    assert resolved == [("resolved", "0")]


# ---------------------------------------------------------------------------
# monitor --once through both CLIs
# ---------------------------------------------------------------------------
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _write_stream(path, storm):
    w = jtelemetry.TelemetryWriter(path, run_id="storm")
    w.write_manifest(kind="storm")
    for i in range(32 if storm else 3):
        w.emit("dispatch_executable", digest=f"s{i:04d}",
               label="online.chunk_runner" if storm else f"label{i}",
               signature=f"f32[{i},64]")
    w.emit("micro_batch", seconds=0.1, docs=4)
    w.close()


MONITOR_CASES = {
    "storm": (True, ["--builtin", "retrace_storm", "--fail-on-alert"]),
    "clean": (False, ["--fail-on-alert"]),
    "retuned": (True, ["--rules", "{rules}", "--fail-on-alert"]),
    "quiet_fleet": (True, ["--builtin", "retrace_storm",
                           "--builtin", "stream_stalled", "--quiet",
                           "--fleet-dir", "{fleet}"]),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_once_through_both_clis(tmp_path, case):
    """``monitor --once`` of one stream through each package's CLI: equal
    exit codes, equal output with numbers and paths masked, equal alert
    logs, and each monitor's own stream read alike by ``metrics``."""
    storm, flags = MONITOR_CASES[case]
    stream = str(tmp_path / "run.jsonl")
    _write_stream(stream, storm)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{"name": "retrace_storm", "value": 100.0}]))
    os.makedirs(tmp_path / "fleet" / "leases")

    def run(p):
        tag = p.al.__name__.split(".")[0]
        alerts, mon = _files(tmp_path, p, "alerts.jsonl", "mon.jsonl")
        argv = ["monitor", "--once", "--stream", stream, "--alerts-file",
                alerts, "--telemetry-file", mon] + [
            a.format(rules=rules, fleet=tmp_path / "fleet") for a in flags]
        parse = (jcli if p.al is jalerts else tcli).build_parser().parse_args
        args = parse(argv)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = args.fn(args)
        p.tel.shutdown()
        text = out.getvalue().replace(tmp_path.as_posix(), "<tmp>")
        text = text.replace(f"<tmp>/{tag}_", "<tmp>/")
        log = [{k: v for k, v in r.items() if k not in ("ts", "checksum")}
               for r in p.al.AlertLog(alerts).replay()[0]]
        _, events = p.metrics.load_run(mon)
        ah = p.metrics.alert_health(events, p.metrics.run_metrics(events))
        return (rc, _NUM.sub("#", text), log,
                None if ah is None else (ah["fired"], [
                    f["rule"] for f in ah["still_firing"]]))

    rc, text, log, health = same(run)
    assert rc == {"storm": 1, "clean": 0, "retuned": 0,
                  "quiet_fleet": 0}[case]
    assert text.startswith("monitoring")
    if case == "storm":
        assert health == (1, ["retrace_storm"])


def test_monitor_without_a_source_exits_2(tmp_path):
    def run(p):
        parse = (jcli if p.al is jalerts else tcli).build_parser().parse_args
        args = parse(["monitor", "--once"])
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = args.fn(args)
        return rc, err.getvalue()

    assert same(run)[0] == 2


# ---------------------------------------------------------------------------
# the chaos sites
# ---------------------------------------------------------------------------
def test_poll_fault_raises_and_the_loop_survives():
    def run(p):
        p.fault.configure("monitor.poll:fail@1")
        with pytest.raises(p.fault.InjectedIOError):
            p.al.AlertEngine([_age_rule(p.al)]).poll(100.0)
        p.tel.configure(None)
        p.fault.configure("monitor.poll:fail@1")
        p.al.AlertEngine([_age_rule(p.al)]).run(interval=0.01,
                                                max_seconds=0.05)
        return p.tel.get_registry().counter("monitor.poll_errors").value

    assert same(run) == 1


def test_action_fault_fails_the_flush(tmp_path):
    def run(p):
        (path,) = _files(tmp_path, p, "actions.json")
        p.fault.configure("monitor.action:fail@1")
        clock = _Clock()
        eng = p.al.AlertEngine(
            [_age_rule(p.al, for_seconds=0.0, action={"kind": "drain"})],
            actions_path=path, now_fn=clock)
        with pytest.raises(p.fault.InjectedIOError):
            _feed(eng, clock, 9.0)
        return os.path.exists(path)

    assert same(run) is False


# ---------------------------------------------------------------------------
# the serve fleet's autoscaler on a scripted sequence of estimates
# ---------------------------------------------------------------------------
def test_autoscaler_writes_the_jax_loops_actions(tmp_path, fixed_time):
    """The port's ``_autoscale`` against the JAX queueing loop's lines
    (``cli.py:1555-1566``), each over its package's
    ``PredictiveAutoscaler`` and ``ActionEmitter``: equal actions files
    after every estimate."""
    rng = np.random.default_rng(3)
    rhos = np.concatenate([rng.uniform(0.85, 1.2, 4), rng.uniform(0.4, 0.6, 3),
                           rng.uniform(0.0, 0.2, 5), [None, 0.95, 0.9],
                           rng.uniform(0.8, 1.0, 6)])
    estimates = [None if r is None else {"rho": float(r), "replicas": 2}
                 for r in rhos]
    kw = dict(min_replicas=1, max_replicas=3, high_rho=0.8, low_rho=0.3,
              confirm=2, cooldown_seconds=2.5)
    files = {}
    for name, p in PKGS.items():
        (path,) = _files(tmp_path, p, "actions.json")
        scaler, emitter = p.q.PredictiveAutoscaler(**kw), \
            p.al.ActionEmitter(path)
        files[name] = []
        for i, ev in enumerate(estimates):
            now = 1000.0 + i
            if name == "port":
                tcli._autoscale(scaler, emitter, ev, now)
            else:
                decision = scaler.decide(ev, now)
                if decision is not None:
                    emitter.emit(decision["action"], alert="autoscale_rho",
                                 key="queueing.rho", value=decision["rho"],
                                 workers_delta=1)
                    emitter.flush()
            files[name].append(p.al.read_actions(path))
    assert files["port"] == files["jax"]
    kinds = [a["kind"] for a in files["port"][-1]["actions"]]
    assert "scale_out" in kinds and "scale_in" in kinds


def test_queueing_tick_feeds_the_autoscaler(tmp_path, fixed_time):
    """One pass of the port's queueing loop with an estimate in hand goes
    to the autoscaler's actions file (and none without one)."""
    path = str(tmp_path / "actions.json")

    class Est:
        def __init__(self, rho):
            self.rho, self.arrivals = rho, 0

        def note_arrivals(self, n, now):
            self.arrivals += n

        def observe_event(self, ts, e):
            pass

        def estimate(self, now):
            return None if self.rho is None else {"rho": self.rho,
                                                   "replicas": 1}

    scaler = tqueueing.PredictiveAutoscaler(min_replicas=1, max_replicas=2,
                                            confirm=1)
    emitter = talerts.ActionEmitter(path)
    telemetry.configure(None)
    telemetry.count("front.request_outcomes.ok", 3)
    assert tcli._queueing_tick(Est(None), None, 0, 5.0, scaler,
                               emitter) == 3
    assert talerts.read_actions(path) == {"actions": []}
    est = Est(0.95)
    assert tcli._queueing_tick(est, None, 1, 6.0, scaler, emitter) == 3
    assert est.arrivals == 2
    (act,) = talerts.read_actions(path)["actions"]
    assert (act["kind"], act["alert"], act["key"], act["workers_delta"]) == (
        "scale_out", "autoscale_rho", "queueing.rho", 1)
