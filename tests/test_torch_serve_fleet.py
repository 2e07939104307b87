"""The port's serve fleet (``supervise --role serve``, the routing front,
the probe) against the JAX package's, on the CPU.

The routers of both packages run the JAX package's selection cases on the
same lease files (picks, pins, repins and exclusions equal); both read one
fleet dir and one models dir alike; each package's lease is read by the
other's front; each front routes to the other package's replica (headers
equal, answers within the serving band, 1e-4); both supervisors run stub
replicas through a staggered bring-up, a rolling swap (control records
equal) and a SIGKILL; the emulated dispatch gives JAX's bytes; the prober
reports JAX's keys.  Then the JAX package's drill runs against the port's
CLI (``--device cpu --serve-emulate-doc-ms 4``), and a fleet of two real
CPU replicas serves a tiny model (k=2, V=64) within 1e-5 of the port's own
per-document scoring and within the serving band of JAX's.  Every wait is
bounded.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.resilience import supervisor as jsup
from spark_text_clustering_tpu.serving import front as jfront
from spark_text_clustering_tpu.serving import probe as jprobe
from spark_text_clustering_tpu.serving import server as jserver
from spark_text_clustering_tpu.telemetry import alerts as jalerts
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.models.persistence import load_model
from spark_text_clustering_tpu_torch.pipeline import (
    TextPreprocessor,
    make_vectorizer,
)
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.resilience import supervisor as tsup
from spark_text_clustering_tpu_torch.serving import front as tfront
from spark_text_clustering_tpu_torch.serving import probe as tprobe
from spark_text_clustering_tpu_torch.serving import server as tserver
from spark_text_clustering_tpu_torch.telemetry import dispatch as tdispatch
from spark_text_clustering_tpu_torch.utils import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTS = {"jax": (jfront, jtelemetry), "port": (tfront, telemetry)}


@pytest.fixture(autouse=True)
def _clean():
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.configure(None)         # registry only; counters live
        tel.get_registry().reset()
    faultinject.reset()
    jfault.reset()
    yield
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    faultinject.reset()
    jfault.reset()


def _write_lease(fleet, index, **fields):
    """A serve replica's lease as the JAX package's tests write it."""
    path = tsup.lease_path(str(fleet), index)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "pid": os.getpid(), "worker": index, "generation": 0,
        "spawn_id": index, "ts": time.time(), "role": "serve",
        "state": "ready", "port": 40000 + index,
        "model_path": "/models/LdaModel_EN_1000",
        "model_stamp": 1000, "queue_depth": 0,
    }
    payload.update(fields)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.03)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# router parity: the JAX package's TestRouterSelection cases on both routers
# ---------------------------------------------------------------------------
def _picks(router, err, calls):
    out = []
    for stream in calls:
        try:
            out.append(router.pick(stream).index)
        except err:
            out.append("none")
    return out


def _least_outstanding(fleet, mod, tel):
    _write_lease(fleet, 0)
    _write_lease(fleet, 1)
    r = mod.FrontRouter(str(fleet), refresh_s=0.0)
    first, second = r.pick(), r.pick()
    r._release(first.index)
    third = r.pick()
    assert {first.index, second.index} == {0, 1}
    assert third.index == first.index
    return [first.index, second.index, third.index, r.outstanding()]


def _draining_and_stale(fleet, mod, tel):
    _write_lease(fleet, 0, state="draining")
    _write_lease(fleet, 1, ts=time.time() - 60.0)
    none = _picks(mod.FrontRouter(str(fleet), refresh_s=0.0,
                                  lease_timeout=5.0),
                  mod.NoReplicaAvailable, [None])
    _write_lease(fleet, 2)
    got = mod.FrontRouter(str(fleet), refresh_s=0.0).pick().index
    assert none == ["none"] and got == 2
    return [none, got]


def _pinning(fleet, mod, tel):
    _write_lease(fleet, 0, model_stamp=1000)
    _write_lease(fleet, 1, model_stamp=2000)
    r = mod.FrontRouter(str(fleet), refresh_s=0.0)
    r._pins["s1"] = 1000
    held = []
    for _ in range(4):
        held.append(r.pick("s1").index)
        r._release(0)
    free = sorted([r.pick().index, r.pick().index])
    reg = tel.get_registry()
    repins_before = reg.counter("front.repins").value
    _write_lease(fleet, 0, model_stamp=2000)
    r.refresh(force=True)
    moved = r.pick("s1").stamp
    assert held == [0] * 4 and free == [0, 1] and repins_before == 0
    assert moved == 2000 and reg.counter("front.repins").value == 1
    return [held, free, repins_before, moved,
            reg.counter("front.repins").value, dict(r._pins)]


def _never_backward(fleet, mod, tel):
    _write_lease(fleet, 0, model_stamp=1000)
    r = mod.FrontRouter(str(fleet), refresh_s=0.0)
    r._pins["s1"] = 2000
    got = _picks(r, mod.NoReplicaAvailable, ["s1", None])
    assert got == ["none", 0]
    return got


def _swap_observed(fleet, mod, tel):
    stream = os.path.join(str(fleet), "front.jsonl")
    tel.configure(stream)
    tel.manifest(kind="front")
    _write_lease(fleet, 0, model_stamp=1000)
    r = mod.FrontRouter(str(fleet), refresh_s=0.0)
    r.refresh(force=True)
    _write_lease(fleet, 0, model_stamp=2000)
    r.refresh(force=True)
    tel.shutdown()
    with open(stream) as f:
        events = [json.loads(x) for x in f]
    (sw,) = [e for e in events if e["event"] == "front_swap_observed"]
    assert (sw["replica"], sw["from_stamp"], sw["to_stamp"]) == (0, 1000, 2000)
    return sorted((k, v) for k, v in sw.items() if k != "ts")


ROUTER_CASES = {
    "least_outstanding": _least_outstanding,
    "draining_and_stale_excluded": _draining_and_stale,
    "generation_pinning_holds_then_repins": _pinning,
    "pin_never_routes_backward": _never_backward,
    "swap_observation_events": _swap_observed,
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_selection_matches_jax(tmp_path, case):
    """Each of the JAX package's router selection cases gives the same
    picks, pins, repins and excluded replicas on both routers."""
    got = {}
    for name, (mod, tel) in FRONTS.items():
        fleet = tmp_path / name
        fleet.mkdir()
        got[name] = ROUTER_CASES[case](fleet, mod, tel)
        tel.get_registry().reset()
    assert got["port"] == got["jax"]


def test_router_healthz_degrades_on_firing_alerts_as_jax(tmp_path):
    """``FrontRouter(alerts_file=)`` on a ready fleet: ``status`` and
    ``alerts`` equal to the JAX router's while an alert fires and after it
    resolves; without the file ``ok`` and no ``alerts`` key."""
    alerts = str(tmp_path / "alerts.jsonl")
    log = jalerts.AlertLog(alerts)
    log.append(rule="budget_burn", key="probe_latency:fast",
               state="firing", ts=1.0)
    _write_lease(tmp_path, 0)
    routers = {name: mod.FrontRouter(str(tmp_path), alerts_file=alerts)
               for name, (mod, _) in FRONTS.items()}
    seen = []
    for _ in range(2):
        got = {name: r.health() for name, r in routers.items()}
        assert {k: got["port"][k] for k in ("status", "alerts", "ready")} \
            == {k: got["jax"][k] for k in ("status", "alerts", "ready")}
        seen.append((got["port"]["status"], [
            f["rule"] for f in got["port"]["alerts"]["firing"]]))
        time.sleep(0.01)
        log.append(rule="budget_burn", key="probe_latency:fast",
                   state="resolved", ts=2.0)
    assert seen == [("degraded", ["budget_burn"]), ("ok", [])]
    plain = tfront.FrontRouter(str(tmp_path)).health()
    assert plain["status"] == "ok" and "alerts" not in plain


# ---------------------------------------------------------------------------
# reading a fleet dir and a models dir; leases across packages
# ---------------------------------------------------------------------------
def test_fleet_and_models_dir_read_alike(tmp_path):
    """``read_replicas``, ``discover_latest_model_dir`` and ``model_stamp``
    give the same answers in both packages on one fleet and models dir."""
    fleet = tmp_path / "fleet"
    _write_lease(fleet, 0)
    _write_lease(fleet, 1, state="draining", model_stamp=None,
                 model_path="/m/LdaModel_EN_1500")
    _write_lease(fleet, 2, done=True, reason="preempted")
    _write_lease(fleet, 3, role="stream")
    _write_lease(fleet, 5, port="x")
    with open(tsup.lease_path(str(fleet), 4), "w") as f:
        f.write("{torn")
    want = [asdict(r) for r in jfront.read_replicas(str(fleet))]
    assert [asdict(r) for r in tfront.read_replicas(str(fleet))] == want
    assert [r["index"] for r in want] == [0, 1]
    m = tmp_path / "models"
    for stamp, committed in ((1000, True), (2000, True), (3000, False)):
        d = m / f"LdaModel_EN_{stamp}"
        d.mkdir(parents=True)
        if committed:
            (d / "COMMIT").write_text("x")
    (m / "LdaModel_GE_9000").mkdir()
    (m / "LdaModel_GE_9000" / "COMMIT").write_text("x")
    for lang in ("EN", "GE", "FR"):
        assert tfront.discover_latest_model_dir(str(m), lang) == \
            jfront.discover_latest_model_dir(str(m), lang)
    assert tfront.discover_latest_model_dir(str(m), "EN").endswith("_2000")
    for p in ("/m/LdaModel_EN_1723456789", "LdaModel_GE_42/", "/m/x", None):
        assert tfront.model_stamp(p) == jfront.model_stamp(p)


def _beat(lease_cls, path, index, port):
    lease = lease_cls(path, interval=0.0, worker_index=index, generation=2,
                      spawn_id=7, static_fields={"role": "serve"})
    lease.beat(force=True, state="starting", port=0)
    lease.beat(force=True, state="ready", port=port,
               model_path="/m/LdaModel_EN_1234", model_stamp=1234,
               swap_id=3, requests=9)
    return lease


def test_leases_interchange(tmp_path):
    """A port replica's lease is read by the JAX front as the port's front
    reads it, and a JAX replica's lease by the port's front: the same
    replica views, the same fields."""
    views = {}
    for writer, cls in (("port", tsup.WorkerLease),
                        ("jax", jsup.WorkerLease)):
        fleet = str(tmp_path / writer)
        _beat(cls, tsup.lease_path(fleet, 1), 1, 4321)
        got = {reader: [asdict(r) for r in mod.read_replicas(fleet)]
               for reader, (mod, _) in FRONTS.items()}
        assert got["port"] == got["jax"]
        (view,) = got["port"]
        views[writer] = view
        with open(tsup.lease_path(fleet, 1)) as f:
            views[writer + "_keys"] = sorted(json.load(f))
    assert {k: v for k, v in views["port"].items() if k not in (
        "pid", "lease_ts")} == {k: v for k, v in views["jax"].items()
                                if k not in ("pid", "lease_ts")}
    assert views["port_keys"] == views["jax_keys"]
    assert views["port"]["stamp"] == 1234 and views["port"]["port"] == 4321


# ---------------------------------------------------------------------------
# routing across packages: each front to the other package's replica
# ---------------------------------------------------------------------------
K, V = 2, 64
VOCAB = [f"h{i}" for i in range(V)]


def _lam(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((K, V)).astype(np.float32) + 0.1


@pytest.fixture()
def python_text(monkeypatch):
    """Both packages' text front ends on their Python path."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_error", "the Python text path, here")
    monkeypatch.setattr(jpipeline.TextPreprocessor, "_use_native",
                        lambda self: False)


def _post(port, texts, stream="s"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/score", body=json.dumps({"texts": texts}),
                     headers={"Content-Type": "application/json",
                              "X-STC-Stream": stream})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def test_fronts_route_to_the_other_packages_replica(tmp_path, python_text):
    """The JAX front routes to an in-process port replica
    (``ScoringService(replica_index=0)``) and the port's front to a JAX
    replica: the same attribution headers, and answers within the serving
    band (1e-4) of each other."""
    models = str(tmp_path / "models")
    JLDAModel(lam=_lam(), vocab=list(VOCAB), alpha=np.full(K, 0.5,
              np.float32), eta=0.1).save(
        os.path.join(models, "LdaModel_EN_1000"))
    kw = dict(lemmatize=False, max_batch=4, linger_s=0.002,
              token_buckets=(64,), watch_model=False, replica_index=0)
    replicas = {
        "port": (tserver, tsup, tserver.ScoringService(
            models, "EN", device="cpu", **kw)),
        "jax": (jserver, jsup, jserver.ScoringService(models, "EN", **kw)),
    }
    texts = ["h1 h2 h2 h3", "h5 h6 h7 h60 h61"]
    answers, headers = {}, {}
    servers = []
    try:
        for rep, front in (("port", "jax"), ("jax", "port")):
            srv_mod, sup_mod, svc = replicas[rep]
            httpd = srv_mod.make_http_server(svc, port=0)
            servers.append((svc, httpd))
            rport = _serve(httpd)
            fleet = str(tmp_path / f"fleet_{rep}")
            lease = sup_mod.WorkerLease(
                sup_mod.lease_path(fleet, 0), interval=0.0,
                static_fields={"role": "serve"})
            lease.beat(force=True, state="ready", port=rport,
                       model_path=svc.scorer.path,
                       model_stamp=svc.scorer.stamp)
            fmod = FRONTS[front][0]
            fhttpd = fmod.make_front_server(
                fmod.FrontRouter(fleet, refresh_s=0.0,
                                 wait_for_replica_s=5.0), port=0)
            servers.append((None, fhttpd))
            status, hdrs, doc = _post(_serve(fhttpd), texts)
            assert status == 200, doc
            answers[rep] = np.asarray(
                [r["distribution"] for r in doc["results"]], np.float32)
            headers[rep] = (hdrs["X-STC-Replica"], hdrs["X-STC-Generation"])
    finally:
        for svc, httpd in servers:
            if svc is not None:
                svc.begin_drain()
            httpd.shutdown()
            httpd.server_close()
    assert headers["port"] == headers["jax"] == ("0", "1000")
    np.testing.assert_allclose(answers["port"], answers["jax"], atol=1e-4)


# ---------------------------------------------------------------------------
# the supervisors against stub replicas
# ---------------------------------------------------------------------------
SERVE_STUB = r"""
import json, os, signal, sys, time

lease, ctrl, gen, sid, idx = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]),
)
models = os.environ.get("STUB_MODELS", "")
stop = {"v": False}
signal.signal(signal.SIGTERM, lambda s, f: stop.update(v=True))


def latest_stamp():
    best = -1
    try:
        for n in os.listdir(models):
            if n.startswith("LdaModel_EN_") and os.path.exists(
                os.path.join(models, n, "COMMIT")
            ):
                best = max(best, int(n.rsplit("_", 1)[1]))
    except (OSError, ValueError):
        pass
    return best


marks = {"spawned": time.time()}


def write(state, stamp, **kw):
    payload = {
        "pid": os.getpid(), "worker": idx, "generation": gen,
        "spawn_id": sid, "ts": time.time(), "role": "serve",
        "state": state, "port": 40000 + idx,
        "model_path": os.path.join(models, f"LdaModel_EN_{stamp}"),
        "model_stamp": stamp, "queue_depth": 0, **marks, **kw,
    }
    tmp = lease + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, lease)


stamp = latest_stamp()
write("starting", stamp)
time.sleep(float(os.environ.get("STUB_READY_DELAY", "0.2")))
marks["ready_at"] = time.time()
write("ready", stamp)
while not stop["v"]:
    time.sleep(0.04)
    try:
        with open(ctrl) as f:
            want = int(json.load(f).get("stamp", -1))
    except (OSError, ValueError):
        want = -1
    if want > stamp:
        time.sleep(float(os.environ.get("STUB_SWAP_DELAY", "0.1")))
        stamp = want
        marks["swapped_at"] = time.time()
    write("ready", stamp)
write("ready", stamp, done=True, reason="preempted")
"""


def _committed_model_dir(models, stamp):
    d = os.path.join(str(models), f"LdaModel_EN_{stamp}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "COMMIT"), "w") as f:
        f.write("x")


def _stub_fleet(tmp_path, sup_mod, fleet, models, **kw):
    stub = tmp_path / "serve_stub.py"
    stub.write_text(SERVE_STUB)
    os.makedirs(os.path.join(fleet, "control"), exist_ok=True)

    def build(index, count, generation, spawn_id):
        return [sys.executable, str(stub), sup_mod.lease_path(fleet, index),
                sup_mod.control_path(fleet, index), str(generation),
                str(spawn_id), str(index)]

    env = dict(os.environ)
    env["STUB_MODELS"] = str(models)
    env.update(kw.pop("stub_env", {}))
    base = dict(models_dir=str(models), lang="EN", workers=2,
                lease_timeout=2.0, grace_seconds=1.0, sweep_interval=0.05,
                startup_grace_seconds=10.0, swap_timeout=5.0, env=env,
                max_seconds=30.0)
    base.update(kw)
    return sup_mod.ServeFleetSupervisor(fleet, build, **base)


def _run_in_thread(sup):
    out = {}
    t = threading.Thread(target=lambda: out.update(report=sup.run()),
                         daemon=True)
    t.start()
    return t, out


def _lease(fleet, i):
    return tsup.read_lease(tsup.lease_path(fleet, i))


def _both_ready(fleet, stamp=None):
    def cond():
        leases = [_lease(fleet, i) or {} for i in (0, 1)]
        return all(x.get("state") == "ready" and (
            stamp is None or x.get("model_stamp") == stamp) for x in leases)
    return cond


def test_staggered_bringup_and_clean_drain(tmp_path):
    """Replica 1 spawns only once the canary's lease says ready; a stop
    drains both, and the fleet ledger holds the one spawn record."""
    fleet = str(tmp_path / "fleet")
    models = tmp_path / "models"
    _committed_model_dir(models, 1000)
    sup = _stub_fleet(tmp_path, tsup, fleet, models,
                      stub_env={"STUB_READY_DELAY": "0.3"})
    t, out = _run_in_thread(sup)
    _wait(_both_ready(fleet), what="both replicas ready")
    l0, l1 = _lease(fleet, 0), _lease(fleet, 1)
    assert l1["spawned"] >= l0["ready_at"]
    sup.request_stop()
    t.join(20)
    rep = out["report"]
    assert rep.converged and (rep.spawns, rep.respawns) == (2, 0)
    cur = tsup.FleetLedger(fleet).current()
    assert cur["kind"] == "spawn" and cur["worker_count"] == 2
    assert all(w.proc.poll() is not None for w in sup._procs.values())


def _roll(tmp_path, tel, sup_mod, tag):
    """One rolling swap on ``sup_mod``'s supervisor: (the control records
    in issue order, the supervisor's swap events, the report)."""
    stream = str(tmp_path / f"sup_{tag}.jsonl")
    tel.configure(stream)
    tel.manifest(kind="supervise", role="serve")
    fleet = str(tmp_path / f"fleet_{tag}")
    models = tmp_path / f"models_{tag}"
    _committed_model_dir(models, 1000)
    sup = _stub_fleet(tmp_path, sup_mod, fleet, models,
                      stub_env={"STUB_SWAP_DELAY": "0.2"})
    controls = []
    issue = sup._issue_swap

    def recorded(index, path, stamp):
        issue(index, path, stamp)
        with open(sup_mod.control_path(fleet, index)) as f:
            rec = json.load(f)
        controls.append((index, rec["id"], rec["stamp"],
                         os.path.basename(rec["swap_to"])))

    sup._issue_swap = recorded
    t, out = _run_in_thread(sup)
    _wait(_both_ready(fleet), what="fleet ready")
    _committed_model_dir(models, 2000)
    _wait(_both_ready(fleet, 2000), what="both replicas swapped")
    l0, l1 = _lease(fleet, 0), _lease(fleet, 1)
    _wait(lambda: sup._roll is None, what="roll done")
    sup.request_stop()
    t.join(20)
    tel.shutdown()
    with open(stream) as f:
        events = [json.loads(x) for x in f]
    swaps = [(e["event"], e.get("worker"), e.get("stamp"),
              e.get("swapped"), e.get("replicas"))
             for e in events if e["event"].startswith("fleet_swap")
             or e["event"] == "fleet_replica_swapped"]
    return controls, swaps, out["report"], (l0, l1)


def test_rolling_swap_is_sequential_and_complete(tmp_path):
    """A newer publish rolls through both replicas one at a time; the
    control files' ids and stamps, and the swap events, equal the JAX
    supervisor's on the same script."""
    got = {}
    for tag, (sup_mod, tel) in (("port", (tsup, telemetry)),
                                ("jax", (jsup, jtelemetry))):
        got[tag] = _roll(tmp_path, tel, sup_mod, tag)
    controls, swaps, rep, (l0, l1) = got["port"]
    assert controls == got["jax"][0] == [
        (0, 1, 2000, "LdaModel_EN_2000"), (1, 2, 2000, "LdaModel_EN_2000")]
    assert swaps == got["jax"][1]
    assert [s[0] for s in swaps] == [
        "fleet_swap_roll", "fleet_replica_swapped", "fleet_replica_swapped",
        "fleet_swap_roll_done"]
    assert swaps[-1][3] == 2
    assert l1["swapped_at"] >= l0["swapped_at"]
    assert rep.swap_rolls == got["jax"][2].swap_rolls == 1


def test_sigkill_respawns_after_retiring_the_lease(tmp_path):
    """A SIGKILLed replica is respawned under a fresh spawn id, its lease
    retired before the respawn is spawned."""
    fleet = str(tmp_path / "fleet")
    models = tmp_path / "models"
    _committed_model_dir(models, 1000)
    sup = _stub_fleet(tmp_path, tsup, fleet, models)
    lease_at_spawn = []
    spawn = sup._spawn

    def spy(index, *a, **k):
        lease_at_spawn.append(
            (index, os.path.exists(tsup.lease_path(fleet, index))))
        return spawn(index, *a, **k)

    sup._spawn = spy
    t, out = _run_in_thread(sup)
    _wait(_both_ready(fleet), what="both replicas ready")
    l0 = _lease(fleet, 0)
    os.kill(l0["pid"], signal.SIGKILL)
    fresh = _wait(lambda: (lambda x: x and x["spawn_id"] != l0["spawn_id"]
                           and x)(_lease(fleet, 0)), what="respawn's lease")
    assert fresh["pid"] != l0["pid"]
    sup.request_stop()
    t.join(20)
    rep = out["report"]
    assert (rep.respawns, rep.crashes) == (1, 1)
    assert tsup.FleetLedger(fleet).current()["kind"] == "respawn"
    assert lease_at_spawn == [(0, False), (1, False), (0, False)]


def _resized(tmp_path, sup_mod, tag):
    """A stub fleet scaled 2 -> 3 -> 1 by a scripted plan once it serves:
    (the fleet ledger's fence records, the report, whether replica 0
    served on through both resizes, the retired replicas' exit codes)."""
    fleet = str(tmp_path / f"fleet_{tag}")
    models = tmp_path / f"models_{tag}"
    _committed_model_dir(models, 1000)
    sup = _stub_fleet(tmp_path, sup_mod, fleet, models, max_workers=3)
    t, out = _run_in_thread(sup)
    _wait(_both_ready(fleet), what="fleet ready")
    pid0 = _lease(fleet, 0)["pid"]
    # a step due at 0 committed epochs (a serve fleet commits none) is
    # taken on the loop's next sweep
    sup.resize_plan.append({"at_epochs": 0, "workers": 3})
    _wait(lambda: (_lease(fleet, 2) or {}).get("state") == "ready",
          what="the third replica ready")
    retired = [sup._procs[i] for i in (1, 2)]
    sup.resize_plan.append({"at_epochs": 0, "workers": 1})
    _wait(lambda: not any(os.path.exists(sup_mod.lease_path(fleet, i))
                          for i in (1, 2)), what="replicas 1 and 2 retired")
    l0 = _lease(fleet, 0)
    served_on = (l0["pid"] == pid0 and l0["state"] == "ready"
                 and sup._procs[0].proc.poll() is None)
    sup.request_stop()
    t.join(20)
    records = [(r["kind"], r["worker_count"],
                {int(i): s for i, s in r["spawn_ids"].items()}, r.get("why"))
               for r in sup_mod.FleetLedger(fleet).records()]
    return records, out["report"], served_on, [
        w.proc.poll() for w in retired]


def _scaled_out_by_action(tmp_path, sup_mod, tel, tag):
    """A stub fleet of two that a monitor's ``serve_p99`` action grows to
    three beside the serving replicas: (fence records, ack, whether both
    stayed up, the report's resizes, ``fleet.actions_applied``)."""
    fleet = str(tmp_path / f"fleet_{tag}")
    models = tmp_path / f"models_{tag}"
    actions = str(tmp_path / f"actions_{tag}.json")
    _committed_model_dir(models, 1000)
    sup = _stub_fleet(tmp_path, sup_mod, fleet, models, max_workers=3,
                      actions_file=actions)
    t, out = _run_in_thread(sup)
    _wait(_both_ready(fleet), what="fleet ready")
    pids = {i: _lease(fleet, i)["pid"] for i in (0, 1)}
    with open(actions, "w") as f:
        json.dump({"schema": 1, "actions": [
            {"id": 1, "kind": "scale_out", "alert": "serve_p99"}]}, f)
    _wait(lambda: (_lease(fleet, 2) or {}).get("state") == "ready",
          what="the scaled-out replica ready")
    kept = {i: _lease(fleet, i)["pid"] for i in (0, 1)} == pids
    sup.request_stop()
    t.join(20)
    records = [(r["kind"], r["worker_count"],
                {int(i): s for i, s in r["spawn_ids"].items()}, r.get("why"))
               for r in sup_mod.FleetLedger(fleet).records()]
    with open(actions + ".ack") as f:
        ack = json.load(f)
    applied = tel.get_registry().snapshot()["counters"].get(
        "fleet.actions_applied")
    return records, ack, kept, out["report"].resizes, applied


def test_action_scales_the_serve_fleet_out_without_a_drain(tmp_path):
    """A ``scale_out`` on the actions file spawns a third replica beside
    the serving two on both supervisors (JAX
    ``test_serve_fleet.py:607``): equal fence records and acks, one
    resize, one applied action, neither serving replica bounced."""
    got = {tag: _scaled_out_by_action(tmp_path, sup_mod, tel, tag)
           for tag, sup_mod, tel in (("port", tsup, telemetry),
                                     ("jax", jsup, jtelemetry))}
    assert got["port"] == got["jax"]
    records, ack, kept, resizes, applied = got["port"]
    assert records == [("spawn", 2, {0: 0, 1: 1}, None),
                       ("resize", 3, {0: 0, 1: 1, 2: 2}, "alert_serve_p99")]
    assert ack == {"last_id": 1} and kept and resizes == 1 and applied == 1


def test_resize_grows_beside_and_drains_only_the_retired(tmp_path):
    """Scale-out spawns a replica next to the serving two and scale-in
    drains only the retired indices, replica 0 serving throughout; the
    fence records and the report equal the JAX supervisor's."""
    got = {tag: _resized(tmp_path, sup_mod, tag)
           for tag, sup_mod in (("port", tsup), ("jax", jsup))}
    records, rep, served_on, codes = got["port"]
    assert records == got["jax"][0] == [
        ("spawn", 2, {0: 0, 1: 1}, None),
        ("resize", 3, {0: 0, 1: 1, 2: 2}, "plan"),
        ("resize", 1, {0: 0}, "plan")]
    assert (rep.resizes, rep.resize_history) == (2, [3, 1]) == (
        got["jax"][1].resizes, got["jax"][1].resize_history)
    assert served_on and got["jax"][2]
    assert None not in codes and None not in got["jax"][3]


# ---------------------------------------------------------------------------
# the emulated dispatch and the prober
# ---------------------------------------------------------------------------
def test_emulated_dispatch_bytes_equal_jax(python_text):
    """``emulate_doc_seconds`` answers JAX's bytes, full and degraded, and
    its warmup skips the buckets under JAX's report keys: both recompile
    sentinels, fresh, see no signature."""
    jmodel = JLDAModel(lam=_lam(), vocab=list(VOCAB),
                       alpha=np.full(K, 0.5, np.float32), eta=0.1)
    tmodel = lda_model_from_numpy(_lam(), np.full(K, 0.5, np.float32), 0.1,
                                  list(VOCAB), device="cpu")
    rows = [(np.array([1, 2], np.int32), np.ones(2, np.float32))] * 3
    jsc = jserver.ServeScorer(jmodel, "/m/LdaModel_EN_7", generation=0,
                              max_batch=4, emulate_doc_seconds=0.001)
    tsc = tserver.ServeScorer(tmodel, "/m/LdaModel_EN_7", generation=0,
                              max_batch=4, emulate_doc_seconds=0.001,
                              device="cpu")
    for degraded in (False, True):
        assert tsc.score_rows(rows, degraded=degraded).tobytes() == \
            jsc.score_rows(rows, degraded=degraded).tobytes()
    jdispatch.reset()
    tdispatch.reset()
    jw, tw = jsc.warmup(), tsc.warmup()
    assert sorted(tw) == sorted(jw)
    assert tw["emulated_doc_seconds"] == jw["emulated_doc_seconds"] == 0.001
    assert tw["signatures"] == jw["signatures"] == {}


class _Stub429(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        ok = self.server.ok
        body = json.dumps({"results": [{"topic": 0}]} if ok else
                          {"error": "intake full"}).encode()
        self.send_response(200 if ok else 429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if ok:
            self.send_header("X-STC-Generation", str(self.server.gen.pop(0)))
            self.send_header("X-STC-Replica", "1")
        else:
            self.send_header("Retry-After", "3")
            self.send_header("X-STC-Degraded", "1")
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def stub_front():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Stub429)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


def test_probe_reports_like_jax(stub_front):
    """Against a front answering generations 5, 7, 6: the same records and
    summary as JAX's prober, one pin violation; against a typed 429 the
    ``rejected`` outcome, counted as ``probe.rejected`` and not as a
    failure (JAX ``tests/test_admission.py``)."""
    host, port = stub_front.server_address
    out = {}
    for name, mod, tel in (("port", tprobe, telemetry),
                           ("jax", jprobe, jtelemetry)):
        stub_front.ok, stub_front.gen = True, [5, 7, 6]
        p = mod.Prober(host, port, timeout=5.0)
        recs = [p.probe_once() for _ in range(3)]
        summary = p._summary()
        stub_front.ok = False
        q = mod.Prober(host, port, priority="batch", timeout=5.0)
        rej = q.probe_once()
        ramp = q.run_ramp(4, rate=100.0, ramp_to=400.0)
        reg = tel.get_registry()
        out[name] = ([{k: v for k, v in r.items() if k != "seconds"}
                      for r in recs + [rej]], summary, ramp,
                     {c: reg.counter(f"probe.{c}").value for c in (
                         "requests", "rejected", "failures",
                         "pin_violations")})
    assert out["port"] == out["jax"]
    recs, summary, ramp, counters = out["port"]
    assert [r["generation"] for r in recs[:3]] == [5, 7, 6]
    assert summary["pin_violations"] == 1
    assert recs[3]["outcome"] == "rejected" and recs[3]["retry_after"] == 3.0
    assert ramp["rejected"] == 5 and ramp["failures"] == 0
    assert counters["rejected"] == 5 and counters["failures"] == 0


# ---------------------------------------------------------------------------
# the port's CLI: the JAX package's drill, then a real-scoring fleet
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def text_lib():
    """The text library, built once before any replica starts."""
    try:
        tnative.build()
    except RuntimeError:
        pass  # the replicas take the Python text path


def _models(root, lam=None):
    models = os.path.join(str(root), "models")
    lda_model_from_numpy(_lam() if lam is None else lam,
                         np.full(K, 0.5, np.float32), 0.1, list(VOCAB),
                         device="cpu").save(
        os.path.join(models, "LdaModel_EN_1000"))
    return models


def _start_fleet(root, models, *extra):
    fleet = os.path.join(str(root), "fleet")
    env = {k: v for k, v in os.environ.items()
           if k not in (faultinject.ENV_SPEC, "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    log = open(os.path.join(str(root), "sup.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "supervise", "--role", "serve", "--fleet-dir", fleet, "--workers",
         "2", "--front-port", "0", "--models-dir", models, "--no-lemmatize",
         "--heartbeat-interval", "0.2", "--lease-timeout", "8",
         "--grace-seconds", "4", "--sweep-interval", "0.1", "--swap-timeout",
         "30", "--max-seconds", "120", "--serve-linger-ms", "1", "--device",
         "cpu", *extra],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    return fleet, proc, log


def _front_port(fleet):
    try:
        with open(os.path.join(fleet, "front.json")) as f:
            return json.load(f)["port"]
    except (OSError, ValueError, KeyError):
        return None


def _ready(port):
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/healthz")
        doc = json.loads(conn.getresponse().read())
        conn.close()
        return doc["ready"]
    except (OSError, http.client.HTTPException, ValueError):
        return -1


def _stop_fleet(root, proc, log):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    with open(os.path.join(str(root), "sup.log")) as f:
        return rc, f.read()


def test_drill_zero_failed_requests_across_publish_and_kill(tmp_path,
                                                            text_lib):
    """The JAX package's drill against the port's CLI: 4 client streams
    through ``supervise --role serve --device cpu --serve-emulate-doc-ms 4``
    while a newer model publishes and rolls through the fleet and replica
    0 is SIGKILLed: no failed request, and every stream's generations
    never go backward."""
    models = _models(tmp_path)
    fleet, proc, log = _start_fleet(tmp_path, models,
                                    "--serve-emulate-doc-ms", "4")
    try:
        port = _wait(lambda: _front_port(fleet), 60, "front announce")
        _wait(lambda: _ready(port) == 2, 60, "2 ready replicas")
        stop = threading.Event()
        per_stream, failures = {}, []
        lock = threading.Lock()

        def client(ci):
            stamps = []
            while not stop.is_set():
                try:
                    status, hdrs, doc = _post(port, [f"h{ci} h2 h3"],
                                              f"drill-{ci}")
                    ok = status == 200 and "topic" in doc["results"][0]
                except (OSError, http.client.HTTPException, ValueError,
                        KeyError) as exc:
                    with lock:
                        failures.append(repr(exc))
                    continue
                if not ok:
                    with lock:
                        failures.append(f"status={status}")
                    continue
                stamps.append(int(hdrs["X-STC-Generation"]))
                time.sleep(0.02)
            with lock:
                per_stream[ci] = stamps

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        src = os.path.join(models, "LdaModel_EN_1000")
        staged = os.path.join(str(tmp_path), "staged")
        shutil.copytree(src, staged)
        os.rename(staged, os.path.join(models, "LdaModel_EN_2000"))
        _wait(lambda: {r.stamp for r in tfront.read_replicas(fleet)
                       if r.ready} == {2000}, 60, "rolling swap to 2000")
        victim = tsup.read_lease(tsup.lease_path(fleet, 0))
        os.kill(victim["pid"], signal.SIGKILL)
        _wait(lambda: (lambda x: x and x["spawn_id"] != victim["spawn_id"])(
            tsup.read_lease(tsup.lease_path(fleet, 0))), 60, "respawn")
        _wait(lambda: _ready(port) == 2, 60, "2 ready again")
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(30)
        assert failures == [], failures[:5]
        assert sum(len(s) for s in per_stream.values()) >= 20
        for ci, stamps in per_stream.items():
            assert stamps == sorted(stamps), (ci, stamps)
        assert any(2000 in s for s in per_stream.values())
    finally:
        rc, out = _stop_fleet(tmp_path, proc, log)
    assert rc == 0, out[-2000:]
    assert "serve fleet drained: 2 replica(s)" in out
    assert "1 respawn(s)" in out and "1 rolling swap(s)" in out


def test_real_scoring_fleet_matches_per_doc_scoring(tmp_path, text_lib,
                                                    python_text):
    """Two ``--device cpu`` replicas with real scoring behind the front:
    every served distribution within 1e-5 of the port's own
    ``topic_distribution(rows, convergence="per_doc")`` on the CPU, and
    within the serving band (1e-4) of the JAX package's service; both
    replicas answer."""
    models = _models(tmp_path)
    texts = [" ".join(f"h{(7 * i + j) % V}" for j in range(3 + i % 9))
             for i in range(12)]
    fleet, proc, log = _start_fleet(tmp_path, models)
    try:
        port = _wait(lambda: _front_port(fleet), 60, "front announce")
        _wait(lambda: _ready(port) == 2, 60, "2 ready replicas")
        served, replicas = [], set()
        for i, text in enumerate(texts):
            status, hdrs, doc = _post(port, [text], f"real-{i % 3}")
            assert status == 200, doc
            served.append(doc["results"][0]["distribution"])
            replicas.add(hdrs["X-STC-Replica"])
    finally:
        rc, out = _stop_fleet(tmp_path, proc, log)
    assert rc == 0, out[-2000:]
    assert replicas == {"0", "1"}
    served = np.asarray(served, np.float32)
    model = load_model(os.path.join(models, "LdaModel_EN_1000"),
                       device="cpu")
    pre = TextPreprocessor(lemmatize=False)
    rows = make_vectorizer(model.vocab)(
        pre.transform({"texts": texts})["tokens"])
    own = np.asarray(model.topic_distribution(rows, convergence="per_doc"),
                     np.float32)
    np.testing.assert_allclose(served, own, atol=1e-5, rtol=0)
    jsvc = jserver.ScoringService(models, "EN", lemmatize=False, max_batch=8,
                                  linger_s=0.002, token_buckets=(64, 256),
                                  watch_model=False)
    try:
        jres = jsvc.submit_texts(texts)
    finally:
        jsvc.begin_drain()
    np.testing.assert_allclose(
        served, np.asarray([r["distribution"] for r in jres], np.float32),
        atol=1e-4, rtol=0)
