"""The port's scoring service (``spark_text_clustering_tpu_torch.serving``)
against the JAX package's, on the CPU.

A small model (K=3 over 64 terms the text front end keeps verbatim) is
saved by the JAX package's ``save_model``; both services load it.  The
port's served bytes must equal the port's own ``topic_distribution(rows,
convergence="per_doc")`` bytes (the serving contract: a response is a pure
function of its document), and lie within 1e-4 of the JAX service's (the
packed per-doc band of ``test_torch_scoring.py``).  Both packages take
their Python text path (nltk), so no native library is built here; the
native path under concurrent requests is held in ``test_torch_cli.py``.
Lingers and poll intervals are milliseconds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.persistence import save_model
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.serving import ScoringService as JService
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu.telemetry import metrics_cli as jmetrics
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.models.persistence import load_model
from spark_text_clustering_tpu_torch.pipeline import (
    TextPreprocessor,
    make_vectorizer,
)
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.serving import (
    DegradeController,
    PendingDoc,
    RequestCoalescer,
    ScoringService,
    ServiceDraining,
    ServiceOverloaded,
    make_http_server,
)
from spark_text_clustering_tpu_torch.telemetry import dispatch as tdispatch
from spark_text_clustering_tpu_torch.serving.front import (
    DEGRADED_HEADER,
    GENERATION_HEADER,
    PRIORITY_HEADER,
)
from spark_text_clustering_tpu_torch.utils import native as tnative

K = 3
V = 64


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh telemetry and fault plans in both packages; both text
    front ends on their Python path."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_error", "the Python text path, here")
    monkeypatch.setattr(jpipeline.TextPreprocessor, "_use_native",
                        lambda self: False)
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    jdispatch.reset()
    tdispatch.reset()
    faultinject.reset()
    jfault.reset()
    yield
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    jdispatch.reset()
    tdispatch.reset()
    faultinject.reset()
    jfault.reset()


def _make_vocab():
    """64 terms the text front end keeps verbatim (JAX
    ``tests/test_serving.py``'s recipe)."""
    cands = [f"x{a}{b}" for a in "bcdfgklmnprtvz" for b in "bcdfgklmnprtvz"]
    pre = TextPreprocessor(stop_words=frozenset(), lemmatize=False,
                           backend="python")
    toks = pre.transform({"texts": [" ".join(cands)]})["tokens"][0]
    keep = [c for c in cands if c in set(toks)]
    assert len(keep) >= V
    return keep[:V]


VOCAB = _make_vocab()


def _model(seed: int) -> JLDAModel:
    rng = np.random.default_rng(seed)
    return JLDAModel(
        lam=rng.random((K, V)).astype(np.float32) + 0.1,
        vocab=list(VOCAB),
        alpha=np.full(K, 0.5, np.float32),
        eta=0.1,
    )


def _texts(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(VOCAB, size=int(rng.integers(5, 30))))
            for _ in range(n)]


def _service(models_dir, **kw):
    kw.setdefault("lemmatize", False)
    kw.setdefault("max_batch", 8)
    kw.setdefault("linger_s", 0.002)
    kw.setdefault("token_buckets", (64, 256))
    kw.setdefault("model_poll_interval", 0.05)
    kw.setdefault("device", "cpu")
    return ScoringService(models_dir, "EN", **kw)


@pytest.fixture()
def models_dir(tmp_path):
    d = str(tmp_path / "models")
    save_model(_model(0), os.path.join(d, "LdaModel_EN_1000"))
    return d


def _per_doc(path, texts):
    """The port's ``topic_distribution(rows, convergence="per_doc")`` of
    ``texts`` under the model at ``path``: what ``score
    --per-doc-convergence`` computes."""
    model = load_model(path, device="cpu")
    pre = TextPreprocessor(stop_words=frozenset(), lemmatize=False)
    rows = make_vectorizer(model.vocab)(
        pre.transform({"texts": texts})["tokens"])
    return np.asarray(model.topic_distribution(rows, convergence="per_doc"),
                      np.float32)


def _served(results):
    return np.asarray([r["distribution"] for r in results],
                      np.float64).astype(np.float32)


@contextlib.contextmanager
def _http(svc):
    httpd = make_http_server(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        svc.begin_drain()
        httpd.shutdown()
        httpd.server_close()


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/score", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=30)


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=10)


# ---------------------------------------------------------------------------
# coalescer mechanics
# ---------------------------------------------------------------------------
def _doc(i, priority="interactive"):
    return PendingDoc(name=f"d{i}",
                      row=(np.zeros(1, np.int32), np.ones(1, np.float32)),
                      priority=priority)


def _answer(batch):
    for d in batch:
        d.distribution = np.zeros(K, np.float32)
        d.done.set()


class _Gated:
    """A dispatch that parks the batch worker until released."""

    def __init__(self):
        self.gate = threading.Event()
        self.batches = []

    def __call__(self, batch):
        self.gate.wait(10.0)
        self.batches.append([(d.name, d.priority) for d in batch])
        _answer(batch)


def _parked(co):
    """Park the worker on a primer doc, so later submits only queue."""
    primer = co.submit(_doc(999))
    deadline = time.monotonic() + 5.0
    while co.queue_depth() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    return primer


class TestCoalescer:
    def test_full_batch_dispatches_without_waiting_for_linger(self):
        telemetry.configure(None)
        seen = []

        def dispatch(batch):
            seen.append(len(batch))
            _answer(batch)

        co = RequestCoalescer(dispatch, max_batch=4, linger_s=5.0)
        docs = [co.submit(_doc(i)) for i in range(4)]
        t0 = time.perf_counter()
        for d in docs:
            assert d.done.wait(2.0)
        assert time.perf_counter() - t0 < 2.0
        co.drain()
        assert seen and seen[0] == 4
        reg = telemetry.get_registry()
        assert reg.counter("serve.batches").value >= 1
        assert reg.histogram("serve.batch_fill").max == 1.0

    def test_linger_deadline_ships_a_partial_batch(self):
        telemetry.configure(None)
        sizes = []

        def dispatch(batch):
            sizes.append(len(batch))
            _answer(batch)

        co = RequestCoalescer(dispatch, max_batch=64, linger_s=0.05)
        doc = co.submit(_doc(0))
        assert doc.done.wait(5.0)
        co.drain()
        assert sizes == [1]
        reg = telemetry.get_registry()
        fill = reg.histogram("serve.batch_fill")
        assert fill.count == 1 and fill.max == pytest.approx(1 / 64)
        assert reg.histogram("serve.queue_seconds").max >= 0.04

    def test_dispatch_failure_quarantines_batch_not_worker(self):
        telemetry.configure(None)
        boom = [True]

        def dispatch(batch):
            if boom[0]:
                boom[0] = False
                raise RuntimeError("injected batch failure")
            _answer(batch)

        co = RequestCoalescer(dispatch, max_batch=2, linger_s=0.5)
        bad = [co.submit(_doc(i)) for i in range(2)]
        for d in bad:
            assert d.done.wait(2.0)
            assert d.error is not None and "injected" in d.error
        ok = co.submit(_doc(9))
        assert ok.done.wait(2.0) and ok.error is None
        co.drain()
        assert telemetry.get_registry().counter(
            "serve.quarantined").value == 2

    def test_drain_refuses_new_and_finishes_queued(self):
        telemetry.configure(None)
        co = RequestCoalescer(_answer, max_batch=4, linger_s=0.001)
        d0 = co.submit(_doc(0))
        co.drain()
        assert d0.done.is_set()
        with pytest.raises(ServiceDraining):
            co.submit(_doc(1))

    def test_queue_full_typed_refusal_under_concurrency(self):
        telemetry.configure(None)
        gated = _Gated()
        co = RequestCoalescer(gated, max_batch=2, linger_s=0.001,
                              max_queue=4)
        primer = _parked(co)
        n = 16
        refused, accepted, errors = [], [], []
        start = threading.Barrier(n)

        def submit(i):
            start.wait(5.0)
            try:
                accepted.append(co.submit(_doc(i)))
            except ServiceOverloaded as exc:
                refused.append(exc)
            except Exception as exc:  # noqa: BLE001 - the test's point
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        assert not errors
        assert len(accepted) == 4 and len(refused) == n - 4
        assert all("intake full" in str(e) for e in refused)
        gated.gate.set()
        for d in accepted + [primer]:
            assert d.done.wait(10.0)
        co.drain()
        assert telemetry.get_registry().counter(
            "admission.rejected.interactive").value == n - 4

    def test_batch_sheds_first(self):
        telemetry.configure(None)
        gated = _Gated()
        co = RequestCoalescer(gated, max_batch=2, linger_s=0.001,
                              max_queue=3)
        primer = _parked(co)
        victims = [co.submit(_doc(i, "batch")) for i in range(3)]
        winner = co.submit(_doc(100))
        assert winner.error_kind is None
        evicted = [v for v in victims if v.done.is_set()]
        assert len(evicted) == 1
        assert evicted[0].error_kind == "ServiceOverloaded"
        assert "batch sheds first" in str(evicted[0].error)
        gated.gate.set()
        for d in [v for v in victims if v is not evicted[0]] + [winner,
                                                               primer]:
            assert d.done.wait(10.0)
        co.drain()
        assert telemetry.get_registry().counter(
            "admission.evicted").value == 1

    def test_batch_never_starved_below_its_weight(self):
        telemetry.configure(None)
        gated = _Gated()
        co = RequestCoalescer(gated, max_batch=8, linger_s=0.001,
                              max_queue=None, batch_weight=0.25)
        primer = _parked(co)
        inter = [co.submit(_doc(i)) for i in range(32)]
        batch = [co.submit(_doc(100 + i, "batch")) for i in range(4)]
        gated.gate.set()
        for d in inter + batch + [primer]:
            assert d.done.wait(10.0)
        co.drain()
        mixed = [b for b in gated.batches if any(p == "batch" for _, p in b)]
        assert len(mixed) == 2, gated.batches
        for popped in mixed:
            assert sum(1 for _, p in popped if p == "batch") == 2
            assert sum(1 for _, p in popped if p != "batch") == 6

    def test_reserve_release_roundtrip(self):
        telemetry.configure(None)
        gated = _Gated()
        co = RequestCoalescer(gated, max_batch=2, linger_s=0.001,
                              max_queue=4)
        co.reserve(3)
        with pytest.raises(ServiceOverloaded):
            co.reserve(2)
        co.release(3)
        co.reserve(4)
        co.release(4)
        gated.gate.set()
        co.drain()


# ---------------------------------------------------------------------------
# the serving contract: bytes, and the JAX service
# ---------------------------------------------------------------------------
def test_concurrent_serving_matches_per_doc_bytes(models_dir):
    """17 client threads, one document each: the served bytes equal the
    port's per-doc scoring of the same texts in one call."""
    telemetry.configure(None)
    svc = _service(models_dir)
    texts = _texts(17)
    results = [None] * len(texts)

    def client(i):
        results[i] = svc.submit_texts([texts[i]], [f"d{i}"])[0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.begin_drain()
    batch = _per_doc(svc.scorer.path, texts)
    assert not np.allclose(batch, 1.0 / K)
    assert _served(results).tobytes() == batch.tobytes()
    for r, dist in zip(results, batch):
        assert r["topic"] == int(np.argmax(dist))
        assert r["model"]["model"].endswith("LdaModel_EN_1000")


def test_port_serves_what_jax_serves(models_dir, tmp_path):
    """The same texts through the JAX service and the port's, each with a
    telemetry stream: distributions within 1e-4, equal result keys and
    attribution, and the JAX package's ``metrics summarize --json`` finds
    the same ``serving_health`` keys in both streams, ``executables``
    included: the same labels with the same calls, digests masked."""
    texts = _texts(12, seed=3)
    names = [f"b{i}" for i in range(len(texts))]
    streams = {"jax": str(tmp_path / "jax.jsonl"),
               "port": str(tmp_path / "port.jsonl")}
    out = {}
    for name, tel, make in (
        ("jax", jtelemetry, lambda: JService(
            models_dir, "EN", lemmatize=False, max_batch=8, linger_s=0.002,
            token_buckets=(64, 256), watch_model=False)),
        ("port", telemetry, lambda: _service(models_dir, watch_model=False)),
    ):
        tel.configure(streams[name])
        tel.manifest(kind="serve")
        svc = make()
        res = svc.submit_texts(texts[:5], names[:5])
        res += svc.submit_texts(texts[5:], names[5:])
        tel.event("serve_drained", **svc.begin_drain())
        tel.shutdown()
        out[name] = (res, svc.warmup_report)
    (jres, jwarm), (tres, twarm) = out["jax"], out["port"]
    np.testing.assert_allclose(_served(tres), _served(jres), atol=1e-4)
    assert [sorted(r) for r in tres] == [sorted(r) for r in jres]
    assert [r["model"] for r in tres] == [r["model"] for r in jres]
    assert [r["name"] for r in tres] == names
    assert sorted(twarm) == sorted(jwarm)

    def health(path):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jmetrics.cmd_summarize(
                argparse.Namespace(run=path, json=True)) == 0
        return json.loads(buf.getvalue())["serving_health"]

    jsh, tsh = health(streams["jax"]), health(streams["port"])
    assert sorted(tsh) == sorted(jsh)
    assert [sorted(x) for x in tsh["executables"]] == [
        sorted(x) for x in jsh["executables"]]
    assert sorted((x["label"], x["calls"]) for x in tsh["executables"]) == \
        sorted((x["label"], x["calls"]) for x in jsh["executables"])
    assert sorted(tsh["warmup"]) == sorted(jsh["warmup"])
    assert sorted(tsh["request_seconds"]) == sorted(jsh["request_seconds"])
    assert tsh["requests"] == jsh["requests"] == len(texts)
    assert tsh["retraces_after_warmup"] == 0


def test_in_bucket_traffic_adds_no_retrace_and_oversize_adds_one(
        models_dir):
    """Warmup runs each bucket's shape once: the recompile sentinel counts
    the second bucket's signature of each of the dispatch's two labels
    (``serve.gather`` and ``serve.topic_inference``), as the JAX package's
    counts; in-bucket traffic adds none; a request past the largest bucket
    adds one signature a label."""
    telemetry.configure(None)
    svc = _service(models_dir)
    at_warmup = svc.warmup_report["retraces_at_warmup"]
    assert at_warmup == 2
    assert svc.warmup_report["signatures"] == {
        "serve.gather": 2, "serve.topic_inference": 2}
    assert svc.warmup_report["compile_cache"] == "off"
    for chunk in range(4):
        svc.submit_texts(_texts(5, seed=chunk))
    reg = telemetry.get_registry()
    assert reg.counter("compile.retraces").value == at_warmup
    # 8 docs of ~40 tokens each: past the 256 bucket, a new shape
    long_texts = [" ".join([" ".join(VOCAB)] * 2)] * 8
    svc.submit_texts(long_texts)
    report = svc.begin_drain()
    assert report["retraces_after_warmup"] == 2
    assert report["retraces_total"] == 4


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------
def _await_swap(svc, path, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if svc.scorer.path == path:
            return True
        time.sleep(0.02)
    return False


def test_concurrent_swap_attributes_every_response_to_one_model(models_dir):
    """Traffic across a hot swap: every response names one of the two
    models, each equals that model's per-doc bytes, both carried
    traffic, and the swap counted once."""
    telemetry.configure(None)
    svc = _service(models_dir)
    path_a = svc.scorer.path
    stop = threading.Event()
    seen, errors = [], []

    def client(i):
        j = 0
        while not stop.is_set():
            texts = _texts(2, seed=i * 100 + j)
            try:
                res = svc.submit_texts(texts)
            except ServiceDraining:
                return
            for text, r in zip(texts, res):
                (errors if "error" in r else seen).append((text, r))
            j += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    path_b = os.path.join(models_dir, "LdaModel_EN_2000")
    save_model(_model(1), path_b)
    assert _await_swap(svc, path_b)
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    svc.begin_drain()
    assert not errors
    by_model = {}
    for text, r in seen:
        by_model.setdefault(r["model"]["model"], []).append((text, r))
    assert set(by_model) == {path_a, path_b}
    for path, pairs in by_model.items():
        gen = {r["model"]["generation"] for _, r in pairs}
        assert gen == {0 if path == path_a else 1}
        want = _per_doc(path, [t for t, _ in pairs])
        assert _served([r for _, r in pairs]).tobytes() == want.tobytes()
    assert telemetry.get_registry().counter("serve.swaps").value == 1


def test_swap_fault_keeps_serving_the_old_model(models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, watch_model=False)
    path_a = svc.scorer.path
    path_b = os.path.join(models_dir, "LdaModel_EN_2000")
    save_model(_model(1), path_b)
    faultinject.configure("serve.swap:fail@1")
    assert svc.poll_model_once() is False
    assert svc.scorer.path == path_a
    assert svc.submit_texts(_texts(1))[0]["model"]["model"] == path_a
    reg = telemetry.get_registry()
    assert reg.counter("serve.swap_failures").value == 1
    assert reg.counter("serve.swaps").value == 0
    faultinject.reset()
    assert svc.poll_model_once() is True
    assert svc.scorer.path == path_b
    svc.begin_drain()


def test_corrupt_candidate_never_installs(models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, watch_model=False)
    path_a = svc.scorer.path
    path_b = os.path.join(models_dir, "LdaModel_EN_2000")
    save_model(_model(1), path_b)
    with open(os.path.join(path_b, "arrays.npz"), "r+b") as f:
        f.truncate(16)
    assert svc.poll_model_once() is False
    assert svc.scorer.path == path_a
    svc.begin_drain()


# ---------------------------------------------------------------------------
# drain and the fault sites
# ---------------------------------------------------------------------------
def test_drain_finishes_queued_then_refuses_with_503(models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, linger_s=0.2, max_batch=64,
                   watch_model=False)
    got = []
    t = threading.Thread(
        target=lambda: got.extend(svc.submit_texts(_texts(3))))
    with _http(svc) as port:
        t.start()
        time.sleep(0.05)
        report = svc.begin_drain()
        t.join(5.0)
        assert len(got) == 3 and all("topic" in r for r in got)
        assert report["requests"] == 3
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"text": "refused"})
        assert err.value.code == 503
        assert json.loads(err.value.read())["status"] == "draining"
    with pytest.raises(ServiceDraining):
        svc.submit_texts(["refused"])
    assert telemetry.get_registry().counter("serve.rejected").value == 2


def test_accept_and_batch_faults_give_errors_and_the_daemon_survives(
        models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, linger_s=0.5, watch_model=False)
    faultinject.configure("serve.accept:fail@1")
    with pytest.raises(faultinject.InjectedIOError):
        svc.submit_texts(_texts(1))
    assert svc.submit_texts(_texts(1))[0]["topic"] >= 0
    faultinject.configure("serve.batch:fail@1")
    out = svc.submit_texts(_texts(2))
    assert all("error" in r for r in out)
    ok = svc.submit_texts(_texts(2, seed=9))
    assert all("topic" in r for r in ok)
    assert telemetry.get_registry().counter("serve.quarantined").value == 2
    svc.begin_drain()


# ---------------------------------------------------------------------------
# HTTP, admission, degraded mode
# ---------------------------------------------------------------------------
def test_http_score_healthz_and_metrics(models_dir, tmp_path):
    telemetry.configure(str(tmp_path / "serve.jsonl"))
    telemetry.manifest(kind="serve")
    svc = _service(models_dir, watch_model=False)
    texts = _texts(3)
    with _http(svc) as port:
        with _post(port, {"texts": texts, "names": ["a", "b", "c"]}) as r:
            assert r.headers[GENERATION_HEADER] == "1000"
            doc = json.loads(r.read())
        assert [x["name"] for x in doc["results"]] == ["a", "b", "c"]
        assert _served(doc["results"]).tobytes() == _per_doc(
            svc.scorer.path, texts).tobytes()
        assert sorted(doc) == ["model", "results", "trace"]
        with _get(port, "/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["requests"] == 3
        with _get(port, "/metrics") as r:
            snap = json.loads(r.read())
        assert snap["counters"]["serve.requests"] == 3
        for path, hdr in (("/metrics?format=prometheus", {}),
                          ("/metrics", {"Accept": "text/plain;version=0.0.4"})):
            with _get(port, path, hdr) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                text = r.read().decode()
            assert "# TYPE stc_serve_batches_total counter" in text
            samples = [ln for ln in text.splitlines()
                       if ln and not ln.startswith("#")]
            assert samples and all(
                len(ln.rsplit(" ", 1)) == 2
                and np.isfinite(float(ln.rsplit(" ", 1)[1]))
                for ln in samples)
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nowhere")
        assert err.value.code == 404


def test_healthz_degrades_on_firing_alerts_as_jax(models_dir, tmp_path):
    """A service with a ``monitor`` alerts log answers ``/healthz`` as the
    JAX service does: ``degraded`` with the firing alert listed while it
    fires, ``ok`` after it resolves (the log's mtime cache read again),
    and no ``alerts`` key without the log."""
    from spark_text_clustering_tpu.telemetry.alerts import AlertLog

    alerts = str(tmp_path / "alerts.jsonl")
    log = AlertLog(alerts)
    log.append(rule="serve_p99", key="", state="firing", value=0.9,
               threshold=0.5, ts=1.0)
    svcs = {"jax": JService(models_dir, "EN", lemmatize=False, max_batch=8,
                            linger_s=0.002, token_buckets=(64,),
                            watch_model=False, alerts_file=alerts),
            "port": _service(models_dir, watch_model=False,
                             token_buckets=(64,), alerts_file=alerts)}
    seen = []
    for _ in range(2):
        got = {name: svc.health() for name, svc in svcs.items()}
        assert {k: got["port"][k] for k in ("status", "alerts")} == {
            k: got["jax"][k] for k in ("status", "alerts")}
        seen.append(got["port"]["status"])
        time.sleep(0.01)
        log.append(rule="serve_p99", key="", state="resolved", ts=2.0)
    assert seen == ["degraded", "ok"]
    with _http(svcs["port"]) as port:
        with _get(port, "/healthz") as r:
            health = json.loads(r.read())
    assert health["status"] == "ok" and health["alerts"] == {
        "source": alerts, "firing": []}
    assert "alerts" not in _service(models_dir, watch_model=False,
                                    token_buckets=(64,)).health()
    for svc in svcs.values():
        svc.begin_drain()


def test_admission_refusal_is_a_priced_429(models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, watch_model=False)
    with _http(svc) as port:
        faultinject.configure("serve.admit:fail@1")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"texts": _texts(1)},
                  headers={PRIORITY_HEADER: "batch"})
        assert err.value.code == 429
        assert 1 <= int(err.value.headers["Retry-After"]) <= 60
        doc = json.loads(err.value.read())
        assert doc["status"] == "overloaded" and doc["priority"] == "batch"
        assert 1 <= doc["retry_after"] <= 60
        with _post(port, {"texts": _texts(2)}) as resp:
            assert resp.status == 200
    assert telemetry.get_registry().counter("serve.rejected").value == 1


def test_a_full_intake_refuses_with_a_priced_429(models_dir):
    """A bound of 2 documents against a 3-document request: one typed
    refusal for the whole request, priced within [1, 60] seconds."""
    telemetry.configure(None)
    svc = _service(models_dir, max_queue=2, watch_model=False)
    with _http(svc) as port:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"texts": _texts(3)})
        assert err.value.code == 429
        assert 1 <= int(err.value.headers["Retry-After"]) <= 60


def test_degraded_mode_marks_responses(models_dir):
    telemetry.configure(None)
    svc = _service(models_dir, watch_model=False, degrade=DegradeController(
        enter_pressure=-1.0, exit_pressure=-2.0, enter_seconds=0.0,
        exit_seconds=3600.0))
    saw = False
    with _http(svc) as port:
        for i in range(4):
            with _post(port, {"texts": _texts(1, seed=i)}) as r:
                doc = json.loads(r.read())
                if r.headers.get(DEGRADED_HEADER):
                    saw = True
                    assert any(x.get("degraded") for x in doc["results"])
        assert saw and svc.health()["degraded_mode"] is True
    reg = telemetry.get_registry()
    assert reg.counter("degrade.entered").value == 1
    assert reg.counter("degrade.responses").value >= 1


class TestDegradeController:
    def _ctl(self, clock):
        return DegradeController(enter_pressure=0.9, exit_pressure=0.6,
                                 enter_seconds=1.0, exit_seconds=3.0,
                                 clock=clock)

    def test_enter_exit_hysteresis_on_a_fake_clock(self):
        telemetry.configure(None)
        now = [0.0]
        ctl = self._ctl(lambda: now[0])
        steps = [(0.0, 0.95, False), (0.5, 0.95, False), (1.1, 0.95, True),
                 (2.0, 0.75, True), (3.0, 0.5, True), (5.0, 0.5, True),
                 (6.1, 0.5, False)]
        for t, p, want in steps:
            now[0] = t
            assert ctl.update(p) is want, (t, p)
        reg = telemetry.get_registry()
        assert reg.counter("degrade.entered").value == 1
        assert reg.counter("degrade.exited").value == 1

    def test_a_blip_below_enter_resets_the_onset(self):
        now = [0.0]
        ctl = self._ctl(lambda: now[0])
        for t, p, want in [(0.0, 0.95, False), (0.9, 0.5, False),
                           (1.5, 0.95, False), (2.0, 0.95, False),
                           (2.6, 0.95, True)]:
            now[0] = t
            assert ctl.update(p) is want, (t, p)

    def test_band_validation(self):
        with pytest.raises(ValueError):
            DegradeController(enter_pressure=0.5, exit_pressure=0.5)
