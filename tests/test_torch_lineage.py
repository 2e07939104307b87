"""The port's ``lineage`` walker and verb against the JAX package's, on the
CPU.

Every fixture is written once by each package (its ``save_model``,
``EpochLedger`` and tracing), and both walkers walk the same files: their
reports must be equal and their trees equal text, after the same faults
(a torn or checksum-corrupt ledger, an unreadable meta.json or stream,
pre-trace records, a compacted ledger, ``lineage.read`` armed in both
plans).  The cases mirror the JAX package's ``tests/test_lineage.py``
one for one; its serve spans run through the port's scoring service and
its subprocess chain through the port's CLI: a supervised 2-worker
``stream-train`` fleet, a traced ``serve --device cpu`` request, then
``lineage`` of the saved response.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import lineage as jlineage
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.persistence import (
    save_model as jsave_model,
)
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.resilience.ledger import (
    EpochLedger as JEpochLedger,
)
from spark_text_clustering_tpu.telemetry import tracing as jtracing
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import lineage
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.models.base import LDAModel
from spark_text_clustering_tpu_torch.models.persistence import save_model
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.resilience.ledger import EpochLedger
from spark_text_clustering_tpu_torch.telemetry import tracing
from spark_text_clustering_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the package that writes a fixture's files
WRITERS = {
    "jax": SimpleNamespace(tracing=jtracing, EpochLedger=JEpochLedger,
                           LDAModel=JLDAModel, save_model=jsave_model),
    "torch": SimpleNamespace(tracing=tracing, EpochLedger=EpochLedger,
                             LDAModel=LDAModel, save_model=save_model),
}
SOURCES = ["/w/a.txt", "/w/b.txt"]


def _reset():
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    for tr in (tracing, jtracing):
        tr.install(None)
    faultinject.reset()
    jfault.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


@pytest.fixture(params=sorted(WRITERS))
def writer(request):
    return WRITERS[request.param]


def _ledgered_model(tmp_path, pkg, *, traced=True, publish=True):
    """A checkpoint-dir ledger with one stream-train epoch and (by
    default) a model-publish record pinning a saved artifact dir, all
    written by ``pkg`` (JAX ``tests/test_lineage.py``'s fixture)."""
    if traced:
        pkg.tracing.install(pkg.tracing.mint())
    ckpt = tmp_path / "ckpt"
    led = pkg.EpochLedger(str(ckpt))
    led.begin(0, kind="stream-train", sources=SOURCES, payloads=[])
    led.commit(0, kind="stream-train", sources=SOURCES)
    model_dir = str(tmp_path / "models" / "LdaModel_EN_1000")
    rng = np.random.default_rng(0)
    model = pkg.LDAModel(
        lam=rng.random((2, 16)).astype(np.float32) + 0.1,
        vocab=[f"h{i}" for i in range(16)],
        alpha=np.full(2, 0.5, np.float32), eta=0.1,
    )
    if publish:
        pkg.save_model(model, model_dir,
                       ledger_ref={"dir": str(ckpt), "epoch": 1})
        led.begin(1, kind="model-publish", sources=[], payloads=[])
        led.commit(1, kind="model-publish", sources=[], model_ref=model_dir)
    else:
        pkg.save_model(model, model_dir)
    pkg.tracing.install(None)
    return str(ckpt), model_dir


def walk_both(target, **kw):
    """The port's report, after holding it and its tree equal to the JAX
    package's on the same files."""
    rep = lineage.walk(target, **kw)
    want = jlineage.walk(target, **kw)
    assert rep == want
    assert lineage.render_tree(rep) == jlineage.render_tree(want)
    return rep


def degraded_counts():
    return tuple(tel.get_registry().counter("lineage.degraded").value
                 for tel in (telemetry, jtelemetry))


class TestWalk:
    def test_model_dir_resolves_publish_and_sources(self, tmp_path, writer):
        ckpt, model_dir = _ledgered_model(tmp_path, writer)
        rep = walk_both(model_dir)
        assert rep["kind"] == "model"
        assert rep["lineage"] == "resolved"
        assert rep["degraded"] == []
        assert rep["model"]["publish_epoch"] == 1
        assert rep["model"]["ledger_dir"] == ckpt
        assert rep["model"]["publish"]["epoch"] == 1
        assert rep["model"]["publish"]["trace_id"] != "unknown"
        assert rep["sources"] == SOURCES
        (worker,) = rep["workers"]
        (epoch_row,) = worker["epochs"]
        assert epoch_row["kind"] == "stream-train"
        assert epoch_row["trace_id"] == rep["model"]["publish"]["trace_id"]

    def test_legacy_pre_trace_records_degrade_not_crash(self, tmp_path,
                                                        writer):
        _, model_dir = _ledgered_model(tmp_path, writer, traced=False)
        rep = walk_both(model_dir)
        assert rep["lineage"] == "resolved"     # sources still resolve
        (worker,) = rep["workers"]
        assert worker["epochs"][0]["trace_id"] == "unknown"
        assert any("predates causal tracing" in d for d in rep["degraded"])

    def test_compacted_ledger_still_resolves_sources(self, tmp_path, writer):
        ckpt, model_dir = _ledgered_model(tmp_path, writer)
        assert writer.EpochLedger(ckpt).compact() is not None
        rep = walk_both(model_dir)
        assert rep["sources"] == SOURCES
        assert rep["lineage"] == "resolved"
        (note,) = rep["degraded"]
        assert "compacted" in note
        # the snapshot pins the publish model_ref, so the publish still
        # attributes (epoch number = the newest committed epoch)
        assert rep["model"]["publish"]["model_ref"] == model_dir

    @pytest.mark.parametrize("damage", ["torn", "checksum"])
    def test_torn_ledger_tail_degrades_typed(self, tmp_path, writer, damage):
        _, model_dir = _ledgered_model(tmp_path, writer)
        path = os.path.join(tmp_path, "ckpt", "epochs.jsonl")
        with open(path, "r+", encoding="utf-8") as f:
            lines = f.readlines()
            f.seek(0)
            f.truncate()
            # a NON-final line: the suffix is untrusted and the ledger read
            # raises CorruptArtifactError
            if damage == "torn":
                lines[0] = lines[0][: len(lines[0]) // 2] + "\n"
            else:
                rec = json.loads(lines[0])
                rec["sources"] = ["/w/forged.txt"]
                lines[0] = json.dumps(rec, sort_keys=True) + "\n"
            f.writelines(lines)
        rep = walk_both(model_dir)
        assert rep["lineage"] == "unknown"
        assert any("unreadable ledger" in d for d in rep["degraded"])

    def test_lineage_read_fault_degrades_typed(self, tmp_path, writer):
        _, model_dir = _ledgered_model(tmp_path, writer)
        telemetry.configure(None)
        jtelemetry.configure(None)
        faultinject.configure("lineage.read:ioerror@1.0")
        jfault.configure("lineage.read:ioerror@1.0")
        rep = walk_both(model_dir)
        assert rep["lineage"] == "unknown"
        assert rep["degraded"]
        port, jax = degraded_counts()
        assert port == jax >= 1

    def test_unreadable_meta_and_stream_degrade_typed(self, tmp_path,
                                                      writer):
        ckpt, model_dir = _ledgered_model(tmp_path, writer)
        with open(os.path.join(model_dir, "meta.json"), "w") as f:
            f.write("{not json")
        rep = walk_both(model_dir, telemetry_paths=[
            str(tmp_path / "missing.jsonl")])
        assert rep["lineage"] == "unknown"
        assert any("unreadable meta" in d for d in rep["degraded"])
        assert any("unreadable telemetry stream" in d
                   for d in rep["degraded"])
        # the ledger given by hand still resolves the sources
        rep = walk_both(model_dir, ledger_dir=ckpt)
        assert rep["lineage"] == "resolved" and rep["sources"] == SOURCES

    def test_unresolvable_target(self, tmp_path):
        rep = walk_both(str(tmp_path / "nope"))
        assert rep["kind"] == "unknown"
        assert rep["lineage"] == "unknown"
        (tmp_path / "plain").mkdir()
        assert walk_both(str(tmp_path / "plain"))["kind"] == "unknown"

    def test_response_json_and_trace_id_targets(self, tmp_path, writer):
        ckpt, model_dir = _ledgered_model(tmp_path, writer)
        trace_id = "ab" * 16
        resp = {
            "results": [{"name": "d0", "topic": 1}],
            "model": {
                "model": model_dir,
                "epoch": 1,
                "ledger_ref": {"dir": ckpt, "epoch": 1},
            },
            "trace": {"trace_id": trace_id, "span_id": "cd" * 8},
        }
        resp_path = tmp_path / "response.json"
        resp_path.write_text(json.dumps(resp))
        rep = walk_both(str(resp_path))
        assert rep["kind"] == "response"
        assert rep["trace_id"] == trace_id
        assert rep["model"]["publish_epoch"] == 1
        assert rep["sources"] == SOURCES
        # a bare trace id resolves through a telemetry stream's
        # trace_request event
        tel = tmp_path / "serve.jsonl"
        tel.write_text(
            json.dumps({"event": "manifest", "schema": 1, "ts": 1.0,
                        "run_id": "t", "kind": "serve"}) + "\n"
            + json.dumps({"ts": 2.0, "event": "trace_request",
                          "trace_id": trace_id, "span_id": "cd" * 8,
                          "model": model_dir, "epoch": 1}) + "\n"
        )
        rep2 = walk_both(trace_id, ledger_dir=ckpt,
                         telemetry_paths=[str(tel)])
        assert rep2["kind"] == "trace"
        assert rep2["model"]["dir"] == model_dir
        assert rep2["sources"] == SOURCES
        # and as a traceparent string
        rep3 = walk_both(f"00-{trace_id}-{'cd' * 8}-01", ledger_dir=ckpt,
                         telemetry_paths=[str(tel)])
        assert rep3["sources"] == SOURCES

    def test_span_attribution_counts_unattributed(self):
        trace_id = "12" * 16
        events = [
            {"event": "trace_request", "trace_id": trace_id,
             "span_id": "aa" * 8},
            {"event": "trace_span", "trace_id": trace_id,
             "name": "serve.request", "span_id": "aa" * 8},
            {"event": "trace_span", "trace_id": trace_id,
             "name": "serve.vectorize", "span_id": "bb" * 8,
             "parent_span_id": "aa" * 8},
            # orphan: parent never emitted
            {"event": "trace_span", "trace_id": trace_id,
             "name": "serve.mystery", "span_id": "cc" * 8,
             "parent_span_id": "ee" * 8},
            # other trace: ignored
            {"event": "trace_span", "trace_id": "34" * 16,
             "name": "other", "span_id": "dd" * 8},
        ]
        spans = lineage.span_attribution(events, trace_id)
        assert spans == jlineage.span_attribution(events, trace_id)
        assert spans["total"] == 3
        assert spans["unattributed"] == 1
        assert spans["unattributed_names"] == ["serve.mystery"]
        assert lineage.span_attribution(events, "56" * 16) is None

    def test_cli_verb_renders_tree_and_json(self, tmp_path, writer):
        _, model_dir = _ledgered_model(tmp_path, writer)

        def run(main, argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = main(argv)
            return rc, out.getvalue()

        rc, out = run(tcli.main, ["lineage", model_dir])
        assert rc == 0 and (rc, out) == run(jcli.main, ["lineage",
                                                        model_dir])
        assert "committed source set (2)" in out
        assert "published by epoch 1" in out
        rc, out = run(tcli.main, ["lineage", model_dir, "--json"])
        assert rc == 0 and (rc, out) == run(jcli.main, ["lineage", model_dir,
                                                        "--json"])
        assert json.loads(out)["model"]["publish_epoch"] == 1
        missing = str(tmp_path / "missing")
        assert run(tcli.main, ["lineage", missing]) == run(
            jcli.main, ["lineage", missing])
        assert run(tcli.main, ["lineage", missing])[0] == 3


def test_lineage_flags_and_defaults_match_jax():
    """The verb's flags, defaults and help equal the JAX CLI's."""
    def verb(parser):
        (sub,) = [a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction)]
        return {(tuple(a.option_strings) or a.dest,
                 tuple(a.default) if isinstance(a.default, list)
                 else a.default, a.help, a.metavar)
                for a in sub.choices["lineage"]._actions}

    assert verb(tcli.build_parser()) == verb(jcli.build_parser())


# ---------------------------------------------------------------------------
# serve request spans (the port's in-process service)
# ---------------------------------------------------------------------------
class TestServeSpans:
    def _served(self, tmp_path, trace=None):
        from tests.test_torch_serving import VOCAB, _model, _service

        models = str(tmp_path / "models")
        jsave_model(_model(0), os.path.join(models, "LdaModel_EN_1000"))
        telemetry.configure(str(tmp_path / "serve.jsonl"), device="cpu")
        telemetry.manifest(kind="serve")
        svc = _service(models)
        try:
            out = svc.submit_texts([" ".join(VOCAB[:5])], trace=trace)
        finally:
            svc.begin_drain(timeout=10)
        telemetry.shutdown()
        events = [json.loads(ln)
                  for ln in open(tmp_path / "serve.jsonl", encoding="utf-8")]
        return out, events

    def test_sampled_request_emits_linked_span_chain(self, tmp_path):
        ctx = tracing.mint()
        out, events = self._served(tmp_path, trace=ctx)
        assert "topic" in out[0]
        spans = lineage.span_attribution(events, ctx.trace_id)
        assert spans == jlineage.span_attribution(events, ctx.trace_id)
        assert spans["total"] == 4
        assert spans["unattributed"] == 0
        assert spans["names"] == [
            "serve.batch_wait", "serve.dispatch", "serve.request",
            "serve.vectorize",
        ]
        (req,) = [e for e in events if e.get("event") == "trace_request"]
        assert req["trace_id"] == ctx.trace_id
        assert req["span_id"] == ctx.span_id
        # the bare trace id walks to the served model (no ledger: typed)
        path = str(tmp_path / "serve.jsonl")
        rep = walk_both(ctx.trace_id, telemetry_paths=[path])
        assert rep["kind"] == "trace" and rep["spans"] == spans
        assert ("serve.topic_inference", "off") in {
            (d["label"], d["cache"]) for d in rep["compile_digests"]}

    def test_unsampled_request_propagates_without_spans(self, tmp_path):
        ctx = tracing.mint(sampled=False)
        out, events = self._served(tmp_path, trace=ctx)
        assert "topic" in out[0]    # scoring unaffected
        assert not [e for e in events if e.get("event") == "trace_span"]

    def test_sampled_dropped_counter_pair(self, tmp_path):
        from tests.test_torch_serving import VOCAB, _model, _service

        models = str(tmp_path / "models")
        jsave_model(_model(0), os.path.join(models, "LdaModel_EN_1000"))
        telemetry.configure(None)
        svc = _service(models)
        try:
            svc.submit_texts([" ".join(VOCAB[:4])],
                             trace=tracing.mint(sampled=True))
            svc.submit_texts([" ".join(VOCAB[:4])],
                             trace=tracing.mint(sampled=False))
        finally:
            svc.begin_drain(timeout=10)
        reg = telemetry.get_registry()
        assert reg.counter("trace.sampled").value == 1
        assert reg.counter("trace.dropped").value == 1


# ---------------------------------------------------------------------------
# the real chain: supervisor -> worker -> ledger -> publish -> serve
# ---------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env.pop(faultinject.ENV_SPEC, None)
    env.pop(faultinject.ENV_SEED, None)
    env.pop(tracing.ENV_CONTEXT, None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _serve_one(tmp_path, model_dir, text, ctx):
    """``serve --device cpu`` as a subprocess of the port's CLI: one POST
    of ``text`` with ``ctx`` in its X-STC-Trace header, then SIGTERM.
    Returns (response body, the serve's run stream path)."""
    tel = str(tmp_path / "serve.jsonl")
    out_path = str(tmp_path / "serve.out")
    with open(out_path, "w+") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             "serve", "--model", model_dir, "--port", "0", "--device",
             "cpu", "--no-lemmatize", "--token-bucket", "256",
             "--max-seconds", "120", "--telemetry-file", tel],
            cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT,
            text=True)
        try:
            port = None
            deadline = time.monotonic() + 90
            while port is None and time.monotonic() < deadline:
                out.seek(0)
                for line in out.read().splitlines():
                    if line.startswith("serving ") and " on http://" in line:
                        port = int(line.split(" on http://")[1]
                                   .split(" ")[0].split(":")[1])
                assert proc.poll() is None, open(out_path).read()
                time.sleep(0.05)
            assert port is not None, open(out_path).read()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/score",
                         body=json.dumps({"texts": [text]}).encode(),
                         headers={"Content-Type": "application/json",
                                  tracing.HEADER: ctx.format()})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200, body
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
    assert rc == 0, open(out_path).read()
    return body, tel


def test_subprocess_chain_one_trace_id_end_to_end(tmp_path):
    """A real 2-worker supervised ``stream-train`` fleet of the port's CLI
    on the CPU, then a traced ``serve --device cpu`` request against the
    model worker 0 published: ONE trace id connects the supervisor's
    fleet records, both workers' committed epochs, the model-publish
    record and the served response's publish attribution, and
    ``lineage`` of the saved response walks it, in both packages alike."""
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        FleetLedger,
    )

    with contextlib.suppress(RuntimeError):
        native.build()      # else the workers take the Python text path
    watch = tmp_path / "watch"
    watch.mkdir()
    pools = ["piano violin orchestra symphony concerto melody",
             "electron proton neutron quantum particle physics"]
    for i in range(4):
        (watch / f"doc{i:02d}.txt").write_text(f"{pools[i % 2]} tok{i}")
    fleet = str(tmp_path / "fleet")
    models = str(tmp_path / "models")
    r = subprocess.run(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "supervise", "--role", "stream-train",
         "--watch-dir", str(watch), "--fleet-dir", fleet,
         "--workers", "2", "--heartbeat-interval", "0.2",
         "--lease-timeout", "8", "--grace-seconds", "2",
         "--sweep-interval", "0.15", "--poll-interval", "0.05",
         "--idle-timeout", "1.0", "--no-lemmatize",
         "--k", "2", "--hash-features", "64", "--seed", "3",
         "--checkpoint-interval", "1", "--models-dir", models,
         "--device", "cpu",
         "--telemetry-file", str(tmp_path / "sup.jsonl")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]

    (root_id,) = {rec["trace_id"] for rec in FleetLedger(fleet).records()}
    publishes = {}
    for w in ("w000", "w001"):
        recs = EpochLedger(os.path.join(fleet, w)).records()
        assert recs, f"{w}: no committed epochs"
        for rec in recs:
            assert rec["trace"]["trace_id"] == root_id, (w, rec)
            assert rec["worker"] == int(w[1:])
        (pub,) = [r_ for r_ in recs if r_["kind"] == "model-publish"]
        publishes[w] = pub

    (name,) = os.listdir(os.path.join(models, "w000"))
    model_dir = os.path.join(models, "w000", name)
    ctx = tracing.mint(sampled=True)
    body, tel = _serve_one(tmp_path, model_dir, pools[0], ctx)
    attr = body["model"]
    assert "topic" in body["results"][0]
    assert body["trace"]["trace_id"] == ctx.trace_id
    assert attr["publish_trace"]["trace_id"] == root_id
    assert attr["epoch"] == publishes["w000"]["epoch"]

    resp_path = tmp_path / "response.json"
    resp_path.write_text(json.dumps(body))
    rep = walk_both(str(resp_path), fleet_dir=fleet, telemetry_paths=[tel])
    assert rep["kind"] == "response" and rep["lineage"] == "resolved"
    assert rep["degraded"] == []
    assert rep["trace_id"] == ctx.trace_id
    assert rep["model"]["publish"]["epoch"] == publishes["w000"]["epoch"]
    assert rep["model"]["publish"]["worker"] == 0
    assert rep["sources"] == sorted(str(watch / n) for n in os.listdir(watch))
    assert {w["worker"] for w in rep["workers"]} == {0, 1}
    assert rep["spans"]["unattributed"] == 0
    assert rep["spans"]["total"] == 4
    assert "serve.request" in rep["spans"]["names"]
    assert ("serve.topic_inference", "off") in {
        (d["label"], d["cache"]) for d in rep["compile_digests"]}

    # the verb on the same files: exit 0 and the walk's JSON
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["lineage", str(resp_path), "--fleet-dir", fleet,
                        "--telemetry", tel, "--json"])
    assert rc == 0
    assert json.loads(out.getvalue()) == json.loads(json.dumps(rep))
    # the model dir alone: its meta.json's ledger_ref is worker 0's dir,
    # and the publish record's artifact_ref names the dir under "path"
    # (both packages), so the walk matches it by epoch
    rep = walk_both(model_dir)
    assert rep["model"]["ledger_dir"] == os.path.join(fleet, "w000")
    assert rep["model"]["publish"]["model_ref"]["path"] == model_dir
