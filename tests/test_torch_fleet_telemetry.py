"""The fleet's telemetry and the collector (ROADMAP item 9c), on the CPU.

The port's ``Collector`` against the JAX package's: the same envelopes
POSTed to each fold into equal streams (timestamps masked), a resent batch
is suppressed, ``recover()`` truncates a torn tail the same way, and the
``collect.ingest`` fault answers 500 and is counted.  Shippers of either
package feed the port's collector.  Both packages' ``FleetSupervisor``
run the same stub workers (no torch, no device) and their supervisor
streams give the JAX package's ``metrics_cli.fleet_health`` the same
section; every spawn carries the supervisor's trace.  Then the port's CLI:
``supervise --telemetry-file --worker-telemetry-dir --ship-to`` with real
``stream-score`` workers (``--device cpu``) under a kill, shipping to the
port's ``collect`` verb, and the verb alone (announce, ingest, drain on
SIGTERM).
"""

from __future__ import annotations

import gzip
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.resilience import faultinject as jfaultinject
from spark_text_clustering_tpu.resilience import supervisor as jsup
from spark_text_clustering_tpu.telemetry import transport as jtransport
from spark_text_clustering_tpu.telemetry.metrics_cli import fleet_health
from spark_text_clustering_tpu_torch import telemetry as ttelemetry
from spark_text_clustering_tpu_torch.cli import _worker_argv, build_parser
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.resilience import supervisor as tsup
from spark_text_clustering_tpu_torch.telemetry import events as tevents
from spark_text_clustering_tpu_torch.telemetry import tracing as ttracing
from spark_text_clustering_tpu_torch.telemetry import transport
from spark_text_clustering_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jtransport, "port": transport}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(transport.ENV_SHIP_TO, raising=False)
    monkeypatch.delenv(ttracing.ENV_CONTEXT, raising=False)
    for mod in (faultinject, jfaultinject):
        mod.reset()
    for tel in (ttelemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    yield
    for mod in (faultinject, jfaultinject):
        mod.reset()
    for tel in (ttelemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    ttracing.install(None)


def _envelope(source_id, seq, events, sent_ts=100.0, replayed=False,
              gz=True):
    raw = json.dumps({"schema": transport.WIRE_SCHEMA,
                      "source_id": source_id, "seq": seq,
                      "sent_ts": sent_ts, "replayed": replayed,
                      "events": events}).encode("utf-8")
    return gzip.compress(raw) if gz else raw


def _post(port, body, gz=True):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/ingest", data=body, method="POST",
        headers={"Content-Type": "application/json",
                 **({"Content-Encoding": "gzip"} if gz else {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, accept="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": accept})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read().decode("utf-8")


class _Server:
    """One package's collector behind its HTTP server on a free port."""

    def __init__(self, mod, collect_dir):
        self.collector = mod.Collector(str(collect_dir))
        self.httpd = mod.make_collector_server(self.collector)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5.0)


def _masked(path):
    """A folded stream's records, the collector's clock stamps removed."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("collect_recv_ts", None)
            if rec.get("event") == "collect_batch":
                rec.pop("ts")
                rec.pop("recv_ts")
            out.append(rec)
    return out


def _folded(collect_dir):
    return {n: _masked(os.path.join(collect_dir, n))
            for n in sorted(os.listdir(collect_dir)) if n.endswith(".jsonl")}


# the wire traffic of two shippers: w0 resends its first batch (an ack it
# never saw), w1 posts one plain and one gzip'd batch
_TRAFFIC = [
    ("w0", 1, [{"event": "manifest", "schema": 1, "run_id": "r0",
                "ts": 1.0}, {"event": "x", "ts": 2.0}], True),
    ("w1", 1, [{"event": "manifest", "schema": 1, "run_id": "r1",
                "ts": 1.5}], False),
    ("w0", 2, [{"event": "y", "ts": 3.0, "n": 4}], True),
    ("w0", 1, [{"event": "manifest", "schema": 1, "run_id": "r0",
                "ts": 1.0}, {"event": "x", "ts": 2.0}], True),
    ("w1", 2, [{"event": "z", "ts": 4.0}] * 3, True),
]


def test_collector_folds_like_jax(tmp_path):
    """The same POSTs to both packages' collectors: equal acks, equal
    folded streams (one a source, marker last, the first manifest stamped
    with its source_id), the resent batch suppressed in both, equal
    /healthz, /metrics counters and Prometheus text."""
    servers = {name: _Server(mod, tmp_path / name)
               for name, mod in PACKAGES.items()}
    try:
        acks = {name: [] for name in servers}
        for sid, seq, events, gz in _TRAFFIC:
            body = _envelope(sid, seq, events, gz=gz)
            for name, srv in servers.items():
                code, ack = _post(srv.port, body, gz=gz)
                ack.pop("recv_ts")
                acks[name].append((code, ack))
        assert acks["port"] == acks["jax"]
        assert [a["status"] for _, a in acks["port"]] == [
            "ok", "ok", "ok", "duplicate", "ok"]
        health = {n: json.loads(_get(s.port, "/healthz"))
                  for n, s in servers.items()}
        assert health["port"] == health["jax"] == {
            "status": "ok", "sources": 2, "batches": 4, "ingested": 7,
            "duplicates": 1}
        snaps = {n: json.loads(_get(s.port, "/metrics"))["counters"]
                 for n, s in servers.items()}
        assert snaps["port"] == snaps["jax"]
        prom = {n: _get(s.port, "/metrics?format=prometheus")
                for n, s in servers.items()}
        assert prom["port"] == prom["jax"]
        assert "collect_duplicates" in prom["port"]
    finally:
        for srv in servers.values():
            srv.stop()
    port, jax = _folded(str(tmp_path / "port")), _folded(str(tmp_path / "jax"))
    assert port == jax and sorted(port) == ["w0.jsonl", "w1.jsonl"]
    assert [r["event"] for r in port["w0.jsonl"]] == [
        "manifest", "x", "collect_batch", "y", "collect_batch"]
    assert port["w0.jsonl"][0]["source_id"] == "w0"


def test_collector_recovers_a_truncated_tail_like_jax(tmp_path):
    """A fold cut between its events and its marker (plus a torn line):
    a new collector of either package truncates the stream back to its
    last marker, counts it the same, folds the re-shipped batch once and
    still suppresses the committed one."""
    streams = {}
    for name, mod in PACKAGES.items():
        d = str(tmp_path / name)
        mod.Collector(d).ingest(
            _envelope("w0", 1, [{"event": "x", "ts": 1.0}]), gzipped=True)
        path = mod.source_stream_path(d, "w0")
        committed = open(path, encoding="utf-8").read()
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"event": "y", "ts": 2.0}) + "\n")
            f.write('{"event": "z", "ts"')
        again = mod.Collector(d)
        assert open(path, encoding="utf-8").read() == committed
        counters = again.registry.snapshot()["counters"]
        assert counters["collect.recovered_streams"] == 1
        assert counters["collect.truncated_events"] == 2
        ok = again.ingest(_envelope("w0", 2, [{"event": "y", "ts": 2.0},
                                              {"event": "z", "ts": 3.0}]),
                          gzipped=True, recv_ts=5.0)
        dup = again.ingest(_envelope("w0", 1, [{"event": "x", "ts": 1.0}]),
                           gzipped=True, recv_ts=6.0)
        assert (ok["status"], dup["status"]) == ("ok", "duplicate")
        streams[name] = _masked(path)
    assert streams["port"] == streams["jax"]
    assert [r["event"] for r in streams["port"]] == [
        "x", "collect_batch", "y", "z", "collect_batch"]


def test_collect_ingest_fault_answers_500_like_jax(tmp_path):
    """``collect.ingest`` fires at the top of the fold: the first POST is
    refused with a 500 and counted in ``collect.ingest_errors``, nothing
    is folded, and the shipper's retry of the same batch folds once."""
    faultinject.configure("collect.ingest:fail@1")
    jfaultinject.configure("collect.ingest:fail@1")
    servers = {name: _Server(mod, tmp_path / name)
               for name, mod in PACKAGES.items()}
    body = _envelope("w0", 1, [{"event": "x", "ts": 1.0}])
    try:
        for srv in servers.values():
            code, ack = _post(srv.port, body)
            assert code == 500 and "collect.ingest" in ack["error"]
            assert not os.path.exists(
                transport.source_stream_path(str(srv.collector.collect_dir),
                                             "w0"))
            code, ack = _post(srv.port, body)
            assert code == 200 and ack["status"] == "ok"
        counters = [s.collector.registry.snapshot()["counters"]
                    for s in servers.values()]
        assert counters[0] == counters[1]
        assert counters[0]["collect.ingest_errors"] == 1
    finally:
        for srv in servers.values():
            srv.stop()
    assert _folded(str(tmp_path / "port")) == _folded(str(tmp_path / "jax"))


@pytest.mark.parametrize("shipper", ["jax", "port"])
def test_shipper_feeds_the_port_collector(tmp_path, monkeypatch, shipper):
    """A run stream of either package with ``STC_SHIP_TO`` on the port's
    collector: the folded stream equals the local one record for record.
    (The port's shipper into the JAX collector is
    ``test_torch_telemetry.test_stc_ship_to_feeds_the_jax_collector``.)"""
    srv = _Server(transport, tmp_path / "collect")
    monkeypatch.setenv(transport.ENV_SHIP_TO, f"127.0.0.1:{srv.port}")
    tel = jtelemetry if shipper == "jax" else ttelemetry
    path = str(tmp_path / "run" / "t.jsonl")
    try:
        tel.configure(path)
        tel.manifest(kind="x")
        for i in range(40):
            tel.event("micro_batch", batch_id=i, docs=2)
        tel.count("ledger.commits", 3)
        tel.shutdown()
    finally:
        tel.shutdown()
        srv.stop()
    (name,) = os.listdir(str(tmp_path / "collect"))
    folded = _masked(str(tmp_path / "collect" / name))
    markers = [r for r in folded if r["event"] == "collect_batch"]
    folded = [r for r in folded if r["event"] != "collect_batch"]
    assert len({m["seq"] for m in markers}) == len(markers) >= 1
    folded[0].pop("source_id")
    assert folded == tevents.read_events(path)
    assert len(folded) == 42


# ---- the supervisor's stream against the JAX supervisor's -------------
STUB = r"""
import json, os, signal, sys, time

lease, gen, sid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mode = os.environ.get("STUB_MODE", "clean")
signal.signal(signal.SIGTERM, lambda s, f: None)   # ignore drains

def write(**kw):
    payload = {"pid": os.getpid(), "generation": gen, "spawn_id": sid,
               "ts": time.time(), "queue_depth": 0,
               "stc_trace": os.environ.get("STC_TRACE"), **kw}
    tmp = lease + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, lease)

write()
if mode == "hang" and sid < 10:
    time.sleep(3600)
if mode == "crash" and sid < 10:
    os._exit(137)
for _ in range(4):
    time.sleep(0.08)
    write()
write(done=True, reason="idle")
"""

_WANT = {
    "crash": {"spawns": 3, "respawns": 1, "crashes": 1, "lease_expiries": 0,
              "preemptions": 0, "resizes": 0},
    "hang": {"spawns": 3, "respawns": 1, "crashes": 0, "lease_expiries": 1,
             "preemptions": 1, "resizes": 0},
}


def _stub_fleet(mod, tel, tmp_path, tag, mode):
    """One package's supervisor over two stub workers, the first
    incarnation of worker 0 crashing or hanging; its stream's events and
    the fleet dir."""
    fleet = str(tmp_path / f"fleet_{tag}")
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    env = {k: v for k, v in os.environ.items()
           if k not in (faultinject.ENV_SPEC, faultinject.ENV_SEED)}
    env["STUB_MODE"] = mode
    path = str(tmp_path / f"sup_{tag}.jsonl")
    tel.configure(path)
    tel.manifest(kind="supervise")
    sup = mod.FleetSupervisor(
        fleet,
        lambda i, n, g, s: [sys.executable, str(stub),
                            mod.lease_path(fleet, i), str(g), str(s)],
        workers=2, lease_timeout=1.0, grace_seconds=0.4,
        sweep_interval=0.1, startup_grace_seconds=10.0, env=env)
    sup._next_spawn_id = 9      # spawn ids 9, 10: only worker 0's first fails
    rep = sup.run()
    tel.shutdown()
    return rep, sup, tevents.read_events(path), fleet


@pytest.mark.parametrize("mode", ["crash", "hang"])
def test_supervisor_stream_gives_jax_fleet_health(tmp_path, mode):
    """Both packages' supervisors over the same stub fleet with one kill:
    ``fleet_health`` of the port's supervisor stream equals that of
    JAX's (spawns, respawns, crashes, lease expiries, preemptions,
    resizes, converged, committed epochs) and the fleet report's counts;
    every spawn event, every fence record and every worker's STC_TRACE
    carry the supervisor's trace id; the counters match the events."""
    sections, reports = {}, {}
    for tag, mod, tel in (("jax", jsup, jtelemetry),
                          ("port", tsup, ttelemetry)):
        rep, sup, events, fleet = _stub_fleet(mod, tel, tmp_path, tag, mode)
        health = fleet_health(events)
        sections[tag] = {k: health[k] for k in (
            *_WANT[mode], "converged", "committed_epochs")}
        reports[tag] = (rep.spawns, rep.respawns, rep.crashes,
                        rep.lease_expiries)
        trace = sup.trace.trace_id
        spawns = [e for e in events if e["event"] == "fleet_spawn"]
        assert {e["trace_id"] for e in spawns} == {trace}
        assert all(e["parent_span_id"] == sup.trace.span_id for e in spawns)
        spawn_sets = [r for r in mod.FleetLedger(fleet).records()
                      if r["kind"] == "spawn"]
        assert [r["trace_id"] for r in spawn_sets] == [trace]
        for i in range(2):
            lease = json.loads(open(mod.lease_path(fleet, i)).read())
            assert lease["stc_trace"].split("-")[1] == trace
        snap = [e for e in events if e["event"] == "registry"][-1]
        assert snap["snapshot"]["counters"]["fleet.spawns"] == 3
        assert snap["snapshot"]["counters"]["fleet.respawns"] == 1
    assert sections["port"] == sections["jax"] == {
        **_WANT[mode], "converged": True, "committed_epochs": 0}
    assert reports["port"] == reports["jax"] == (
        3, 1, _WANT[mode]["crashes"], _WANT[mode]["lease_expiries"])


def test_lease_and_fence_telemetry_like_jax(tmp_path):
    """A worker's lease renewal carries its adopted trace and counts
    ``fleet.heartbeats``; a superseded fence token counts
    ``ledger.fence_refusals`` and emits ``fence_refused``: in both
    packages, under the same names."""
    ctx = ttracing.mint()
    ttracing.install(ctx)
    from spark_text_clustering_tpu.telemetry import tracing as jtracing

    jtracing.install(jtracing.parse(ctx.format()))
    try:
        got = {}
        for tag, mod, tel in (("jax", jsup, jtelemetry),
                              ("port", tsup, ttelemetry)):
            fleet = str(tmp_path / tag)
            path = str(tmp_path / f"{tag}.jsonl")
            tel.configure(path)
            lease = mod.WorkerLease(mod.lease_path(fleet, 0), interval=0.0)
            lease.beat(queue_depth=3)
            lease.beat(queue_depth=1)
            mod.FleetLedger(fleet).append(kind="spawn", generation=1,
                                          worker_count=1, spawn_ids={0: 4})
            fence = mod.FleetFence(fleet, 0, 0, 0)
            with pytest.raises(Exception, match="superseded"):
                fence.verify()
            tel.shutdown()
            record = mod.read_lease(mod.lease_path(fleet, 0))
            assert record["trace_id"] == ctx.trace_id
            events = tevents.read_events(path)
            (refused,) = [e for e in events if e["event"] == "fence_refused"]
            counters = events[-1]["snapshot"]["counters"]
            got[tag] = (counters["fleet.heartbeats"],
                        counters["ledger.fence_refusals"],
                        {k: refused[k] for k in (
                            "worker", "generation", "spawn_id",
                            "current_generation")})
    finally:
        jtracing.install(None)
    assert got["port"] == got["jax"] == (
        2, 1, {"worker": 0, "generation": 0, "spawn_id": 0,
               "current_generation": 1})


def test_worker_argv_names_one_stream_per_incarnation(tmp_path):
    """``--worker-telemetry-dir`` puts ``--telemetry-file
    <dir>/worker-wNNN-sSS.jsonl`` in each worker's argv, the JAX package's
    name; without it no worker writes a stream."""
    args = build_parser().parse_args([
        "supervise", "--watch-dir", "w", "--fleet-dir", "f",
        "--worker-telemetry-dir", str(tmp_path)])
    argv = _worker_argv(args, 1, 2, 0, 7)
    i = argv.index("--telemetry-file")
    assert argv[i + 1] == str(tmp_path / "worker-w001-s7.jsonl")
    plain = build_parser().parse_args([
        "supervise", "--watch-dir", "w", "--fleet-dir", "f"])
    assert "--telemetry-file" not in _worker_argv(plain, 1, 2, 0, 7)


def _env():
    env = dict(os.environ)
    for key in (faultinject.ENV_SPEC, faultinject.ENV_SEED,
                transport.ENV_SHIP_TO, ttracing.ENV_CONTEXT):
        env.pop(key, None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _start_collect(collect_dir, *extra):
    """``cli collect`` as a subprocess; (process, announce)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "collect", "--dir", str(collect_dir), *extra],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ann = transport.read_collect_announce(str(collect_dir), wait_s=120.0)
    except TimeoutError:
        proc.kill()
        raise
    return proc, ann


def test_collect_verb_announces_ingests_and_drains(tmp_path):
    """``collect`` announces its bound port in collect.json, folds a POSTed
    batch, answers /healthz, and on SIGTERM drains and exits 0 with a
    summary line; its own stream holds the collect.* counters and never
    ships to itself."""
    collect_dir = tmp_path / "collect"
    own = tmp_path / "own.jsonl"
    proc, ann = _start_collect(collect_dir, "--telemetry-file", str(own))
    try:
        assert ann["host"] == "127.0.0.1" and ann["pid"] == proc.pid
        code, ack = _post(ann["port"], _envelope(
            "w0", 1, [{"event": "manifest", "schema": 1, "ts": 1.0},
                      {"event": "x", "ts": 2.0}]))
        assert (code, ack["status"]) == (200, "ok")
        health = json.loads(_get(ann["port"], "/healthz"))
        assert health["batches"] == 1 and health["ingested"] == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "collector drained: 1 source(s), 1 batch(es), 2 event(s), " \
           "0 duplicate batch(es) suppressed" in out
    assert sorted(os.listdir(collect_dir)) == ["collect.json", "w0.jsonl"]
    events = tevents.read_events(str(own))
    assert events[0]["event"] == "manifest" and events[0]["kind"] == "collect"
    assert events[-1]["snapshot"]["counters"]["collect.batches"] == 1


@pytest.fixture(scope="module")
def fleet_fixture(tmp_path_factory):
    """A model and a 6-file watch dir (the fleet tests' shapes); the text
    library is built before any worker starts."""
    try:
        native.build()
    except RuntimeError:
        pass  # the workers take the Python text path
    root = tmp_path_factory.mktemp("fleet_tel")
    rng = np.random.default_rng(0)
    v = 64
    model = lda_model_from_numpy(
        rng.random((2, v)).astype(np.float32) + 0.1,
        np.full(2, 0.5, np.float32), 0.1, [f"h{i}" for i in range(v)],
        algorithm="online", device="cpu")
    model_dir = str(root / "models" / "LdaModel_EN_1000")
    model.save(model_dir)
    watch = root / "watch"
    watch.mkdir()
    pools = ["piano violin orchestra symphony concerto melody",
             "electron proton neutron quantum particle physics"]
    for i in range(6):
        (watch / f"doc{i:02d}.txt").write_text(f"{pools[i % 2]} tok{i}")
    return {"root": root, "watch": str(watch), "model": model_dir}


def test_supervise_fleet_telemetry_end_to_end(fleet_fixture):
    """``supervise --telemetry-file --worker-telemetry-dir --ship-to`` with
    two ``stream-score`` workers on the CPU, worker 0 killed at its first
    commit, shipping to a ``collect`` subprocess: one local stream per
    worker incarnation, the supervisor's fleet health equal to the
    printed report, every stream on the supervisor's trace, and the
    collector holding one stream per incarnation plus the supervisor's,
    with no (source_id, seq) folded twice."""
    root = fleet_fixture["root"]
    collect_dir = root / "collect"
    proc, ann = _start_collect(collect_dir)
    wdir = root / "wtel"
    sup_path = root / "sup.jsonl"
    try:
        out = subprocess.run(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             "supervise", "--role", "stream-score",
             "--watch-dir", fleet_fixture["watch"],
             "--fleet-dir", str(root / "fleet"), "--workers", "2",
             "--heartbeat-interval", "0.2", "--lease-timeout", "2.5",
             "--grace-seconds", "1.0", "--sweep-interval", "0.15",
             "--poll-interval", "0.05", "--idle-timeout", "0.8",
             "--max-files-per-trigger", "1", "--no-lemmatize",
             "--model", fleet_fixture["model"],
             "--output-dir", str(root / "out"),
             "--chaos-worker", "0:ledger.commit:kill@1",
             "--telemetry-file", str(sup_path),
             "--worker-telemetry-dir", str(wdir),
             "--ship-to", f"127.0.0.1:{ann['port']}",
             "--device", "cpu"],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=300)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "3 spawn(s), 1 respawn(s)" in out.stdout
    assert "1 crash(es)" in out.stdout
    assert sorted(os.listdir(wdir)) == [
        "worker-w000-s0.jsonl", "worker-w000-s2.jsonl",
        "worker-w001-s1.jsonl"]
    sup_events = tevents.read_events(str(sup_path))
    assert sup_events[0]["kind"] == "supervise"
    health = fleet_health(sup_events)
    assert (health["spawns"], health["respawns"], health["crashes"]) == (
        3, 1, 1)
    (trace,) = {e["trace_id"] for e in sup_events
                if e["event"] == "fleet_spawn"}
    for name in os.listdir(wdir):
        events = tevents.read_events(str(wdir / name))
        assert {e["trace_id"] for e in events if "trace_id" in e} == {trace}
        assert any(e["event"] == "trace_adopt" for e in events)
    # each collected stream is its local stream folded exactly once: all
    # of it for the supervisor and the incarnations that ran to their
    # end; the incarnation killed at its first commit loses what its
    # shipper had not yet sent (here it may not have sent anything)
    local = {"sup": tevents.read_events(str(sup_path)),
             **{n[:-len(".jsonl")]: tevents.read_events(str(wdir / n))
                for n in os.listdir(wdir)}}
    folded = {}
    for name in os.listdir(collect_dir):
        if not name.endswith(".jsonl"):
            continue
        recs = [json.loads(line)
                for line in open(collect_dir / name, encoding="utf-8")]
        seqs = [r["seq"] for r in recs if r["event"] == "collect_batch"]
        assert len(seqs) == len(set(seqs)) >= 1
        events = [r for r in recs if r["event"] != "collect_batch"]
        for key in ("source_id", "collect_recv_ts"):
            events[0].pop(key)
        (stem,) = [s for s in local if name.endswith(f"-{s}.jsonl")]
        folded[stem] = events
    assert {"sup", "worker-w000-s2", "worker-w001-s1"} <= set(folded)
    for stem, events in folded.items():
        want = local[stem]
        if stem == "worker-w000-s0":
            want = want[:len(events)]
        assert events == want, stem
        assert {e["trace_id"] for e in events if "trace_id" in e} == {trace}
