"""The library arguments the JAX package accepts, in the port: each call
that works against the JAX package works against the port and does the
same thing, on the same inputs made from a seed (numpy), on the CPU.

The vocabulary (``CountVectorizer``'s ``num_workers`` and
``docs_are_process_local``, the sharded count and the merge over a
2-rank gloo grid), model I/O (``load_reference_model``'s ``vocab``,
``save_reference_model``'s ``write_vocab_sidecar``), the text front end
(``preprocess_documents``' ``max_workers``), telemetry and the fleet
(``configure``'s ``run_id`` / ``fresh_registry`` / ``ship_to``,
``configure_shipping``'s ``source_id`` / ``spool_dir``, ``JsonlSink``'s
``truncate``, ``TelemetryWriter``'s ``run_id``, ``heartbeat_callback``'s
``source``, ``FleetSupervisor``'s ``heartbeat_interval``,
``ServeFleetSupervisor``'s ``stagger``), the library arguments outside
those modules (``Params``' field order, ``gamma_fixed_point_segments``'
``reduce_fn``/``freeze``, ``infer_gamma``'s and ``topic_inference``'s
``backend``, ``initialize_distributed``'s ``coordinator_address``,
``gather_token_rows``' ``idx``), each called by keyword and by position,
and one parametrised test that holds every signature these touch to the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_text_clustering_tpu import config as jconfig
from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.models import base as jbase
from spark_text_clustering_tpu.ops import lda_math as jlda
from spark_text_clustering_tpu.ops import sparse as jsparse
from spark_text_clustering_tpu.parallel import mesh as jmesh
from spark_text_clustering_tpu.resilience import supervisor as jsup
from spark_text_clustering_tpu.telemetry import events as jevents
from spark_text_clustering_tpu.telemetry import transport as jtransport
from spark_text_clustering_tpu.utils import textproc as jtextproc
from spark_text_clustering_tpu.utils import vocab as jvocab
from spark_text_clustering_tpu_torch import config as tconfig
from spark_text_clustering_tpu_torch import pipeline as tpipeline
from spark_text_clustering_tpu_torch import telemetry as ttelemetry
from spark_text_clustering_tpu_torch.models import base as tbase
from spark_text_clustering_tpu_torch.models import reference_export as texport
from spark_text_clustering_tpu_torch.models import reference_import as timport
from spark_text_clustering_tpu_torch.ops import lda_math as tlda
from spark_text_clustering_tpu_torch.ops import sparse as tsparse
from spark_text_clustering_tpu_torch.parallel import mesh as tmesh
from spark_text_clustering_tpu_torch.parallel import run_grid
from spark_text_clustering_tpu_torch.resilience import supervisor as tsup
from spark_text_clustering_tpu_torch.telemetry import events as tevents
from spark_text_clustering_tpu_torch.telemetry import transport as ttransport
from spark_text_clustering_tpu_torch.utils import native as tnative
from spark_text_clustering_tpu_torch.utils import vocab as tvocab

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_vocab_worker  # noqa: E402

WORDS = [f"w{i}" for i in range(300)]


def _docs(n_docs: int, seed: int = 0):
    """Token lists with Zipf-like counts and many ties at the cut."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    return [[WORDS[i] for i in rng.choice(len(WORDS), rng.integers(5, 60),
                                          p=p)]
            for _ in range(n_docs)]


# -- the vocabulary ----------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_count_vectorizer_workers_match_jax(workers):
    """``num_workers`` shards the count across host processes in both
    packages (64 documents: every worker gets 16); the vocabularies equal
    each other and the serial count's."""
    docs = _docs(64, seed=workers)
    ds = {"tokens": docs}
    want = jvocab.build_vocab(jvocab.count_terms(docs), 40)[0]
    jm = jpipeline.CountVectorizer(vocab_size=40, num_workers=workers).fit(ds)
    tm = tpipeline.CountVectorizer(vocab_size=40, num_workers=workers).fit(ds)
    assert tm.vocab == jm.vocab == want
    assert tvocab.count_terms_parallel(docs, workers) == (
        jvocab.count_terms(docs))


def test_merge_without_a_process_group_returns_the_counter():
    """One process (no ``torch.distributed`` group): the merge returns its
    counter unchanged, as JAX's does at ``process_count() == 1``, and
    ``docs_are_process_local`` gives the local vocabulary."""
    docs = _docs(20)
    counts = tvocab.count_terms(docs)
    assert tvocab.merge_term_counts_multihost(counts) is counts
    assert jvocab.merge_term_counts_multihost(counts) is counts
    ds = {"tokens": docs}
    assert tpipeline.CountVectorizer(
        vocab_size=30, docs_are_process_local=True).fit(ds).vocab == (
        jpipeline.CountVectorizer(
            vocab_size=30, docs_are_process_local=True).fit(ds).vocab)
    assert tvocab.build_vocab_multihost(docs, 30, 1) == (
        jvocab.build_vocab_multihost(docs, 30, 1))


def test_process_local_docs_on_a_grid_give_the_serial_vocabulary():
    """A 2-rank gloo grid, each rank holding its own half of the documents
    with ``docs_are_process_local=True``: both ranks derive the serial
    count's vocabulary of the whole corpus (the JAX package's multi-host
    ingest check, on the port's process group)."""
    docs = _docs(41, seed=7)
    want = jvocab.build_vocab(jvocab.count_terms(docs), 50)[0]
    out = run_grid(torch_vocab_worker.vocab_rank, 2, 1, (docs, 50),
                   backend="gloo", device="cpu", timeout=300)
    assert [n for _, n in out] == [21, 20]
    assert [v for v, _ in out] == [want, want]
    # a rank alone would have ranked another top-50
    assert jvocab.build_vocab(jvocab.count_terms(docs[0::2]), 50)[0] != want


# -- model I/O ---------------------------------------------------------------
def _lda_models(seed=3, k=4, v=23):
    from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
    from spark_text_clustering_tpu_torch.models.base import LDAModel

    rng = np.random.default_rng(seed)
    common = dict(lam=rng.gamma(2.0, 3.0, (k, v)).astype(np.float32),
                  vocab=[f"stem{i}" for i in range(v)],
                  alpha=rng.uniform(1.5, 9.0, k).astype(np.float32),
                  eta=1.1, gamma_shape=100.0, iteration_times=[0.5, 0.25],
                  algorithm="em", step=2)
    return JLDAModel(**common), LDAModel(device="cpu", **common)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_export_without_sidecar_equals_jaxs(tmp_path):
    """``write_vocab_sidecar=False``: both exporters write the same tree,
    with no ``vocabularies/`` beside the model; the default still writes
    the sidecar."""
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_text_clustering_tpu.models.reference_export import (
        save_reference_model as jsave,
    )

    jmodel, tmodel = _lda_models()
    for tag, sidecar in (("off", False), ("on", True)):
        paths = {}
        for name, save, model in (("jax", jsave, jmodel),
                                  ("port", texport.save_reference_model,
                                   tmodel)):
            paths[name] = str(tmp_path / tag / name / "LdaModel_EN_1000")
            save(model, paths[name], write_vocab_sidecar=sidecar)
        roots = {n: os.path.dirname(p) for n, p in paths.items()}
        assert _listing(roots["port"]) == _listing(roots["jax"])
        assert os.path.isdir(os.path.join(roots["port"], "vocabularies")) \
            == sidecar
        for rel in _listing(paths["jax"]):
            a = os.path.join(paths["jax"], rel)
            b = os.path.join(paths["port"], rel)
            if rel.endswith(".parquet"):
                assert pq.read_table(b).equals(pq.read_table(a))
            else:
                assert open(b, "rb").read() == open(a, "rb").read()


def test_load_with_a_vocab_positional_and_by_keyword(tmp_path):
    """``load_reference_model(path, vocab)`` binds ``vocab`` at JAX's
    position: positional and by keyword, the port's model equals the JAX
    package's (the sidecar is not read, and none is needed)."""
    pytest.importorskip("pyarrow")
    from spark_text_clustering_tpu.models import reference_import as jimport

    jmodel, tmodel = _lda_models(seed=9)
    path = str(tmp_path / "LdaModel_EN_2000")
    texport.save_reference_model(tmodel, path, write_vocab_sidecar=False)
    vocab = [f"term{i:02d}" for i in range(tmodel.vocab_size)]
    want = jimport.load_reference_model(path, vocab)
    assert want.vocab == vocab
    for got in (timport.load_reference_model(path, vocab, device="cpu"),
                timport.load_reference_model(path, vocab=vocab,
                                             device="cpu"),
                timport.load_reference_model(path, vocab, False, "cpu")):
        assert got.vocab == want.vocab
        np.testing.assert_array_equal(np.asarray(got.lam),
                                      np.asarray(want.lam))
        np.testing.assert_array_equal(np.asarray(got.alpha),
                                      np.asarray(want.alpha))
        assert (got.eta, got.gamma_shape, got.step) == (
            want.eta, want.gamma_shape, want.step)
    with pytest.raises(FileNotFoundError):
        timport.load_reference_model(path, None, False, "cpu")
    with pytest.raises(FileNotFoundError):
        jimport.load_reference_model(path, None, False)


# -- the text front end ------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_documents_max_workers(workers):
    """``max_workers`` threads of the native front end give the tokens of
    the JAX package's ``preprocess_document``, document for document."""
    assert tnative.native_available()
    rng = np.random.default_rng(11)
    words = ["The", "running", "dogs", "were", "happily", "jumping",
             "over", "fences;", "Holmes", "said", "littlest", "very"]
    texts = [" ".join(rng.choice(words, rng.integers(3, 40))) + "."
             for _ in range(9)]
    stop = frozenset({"the", "were"})
    want = [jtextproc.preprocess_document(t, stop_words=stop) for t in texts]
    assert tnative.preprocess_documents(texts, stop_words=stop,
                                        max_workers=workers) == want


# -- telemetry and the fleet -------------------------------------------------
def _stream(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(x) for x in f if x.strip()]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_configure_run_id_and_fresh_registry(tmp_path, pkg):
    """``run_id`` stamps the stream; ``fresh_registry=False`` keeps what
    the registry counted before; the default resets it."""
    tel = jtelemetry if pkg == "jax" else ttelemetry
    path = str(tmp_path / "t.jsonl")
    try:
        tel.configure(None)
        tel.count("v1.before", 3)
        tel.configure(path, run_id="run-v1", fresh_registry=False)
        tel.manifest(kind="test")
        tel.count("v1.after")
        tel.shutdown()
        ev = _stream(path)
        assert ev[0]["event"] == "manifest" and ev[0]["run_id"] == "run-v1"
        counters = ev[-1]["snapshot"]["counters"]
        assert counters["v1.before"] == 3 and counters["v1.after"] == 1
        tel.configure(path)
        tel.shutdown()
        ev = _stream(path)
        assert "v1.before" not in ev[-1]["snapshot"]["counters"]
        assert ev[0]["run_id"] != "run-v1"
    finally:
        tel.shutdown()


def _closed_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_configure_ship_to(tmp_path, pkg):
    """``ship_to`` installs the shipper for the run stream without the env
    variable; with the collector down, the records spool beside the
    stream."""
    tel, tr = ((jtelemetry, jtransport) if pkg == "jax"
               else (ttelemetry, ttransport))
    path = str(tmp_path / "t.jsonl")
    url = f"127.0.0.1:{_closed_port()}"
    try:
        tel.configure(path, ship_to=url)
        assert tr._shipper is not None
        assert (tr._shipper.host, tr._shipper.port) == tr.parse_ship_url(url)
        tel.manifest(kind="test")
    finally:
        tel.shutdown()
    assert tr._shipper is None
    spool = tmp_path / "ship-spool"
    assert spool.is_dir() and any(spool.iterdir())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_configure_shipping_source_id_and_spool_dir(tmp_path, pkg):
    tr = jtransport if pkg == "jax" else ttransport
    spool = str(tmp_path / "my-spool")
    try:
        s = tr.configure_shipping(f"127.0.0.1:{_closed_port()}",
                                  stream_path=str(tmp_path / "t.jsonl"),
                                  source_id="source-7", spool_dir=spool,
                                  flush_interval=0.05)
        assert s.source_id == "source-7" and s.flush_interval == 0.05
        assert s.spool.spool_dir == spool
        tr.offer({"event": "thing", "n": 1})
    finally:
        tr.close_shipping()
    # the collector is down: the record spooled where it was told to
    assert os.listdir(spool) == ["ship-spool.jsonl"]
    assert not os.path.exists(tmp_path / "ship-spool")


def test_jsonl_sink_truncate_and_writer_run_id(tmp_path):
    """``truncate=False`` appends to what the file holds (the default
    starts it empty); ``TelemetryWriter(run_id=)`` stamps its records:
    byte for byte the JAX package's file, the timestamps aside."""
    out = {}
    for pkg, ev in (("jax", jevents), ("port", tevents)):
        path = tmp_path / f"{pkg}.jsonl"
        path.write_text('{"old": 1}\n')
        ev.JsonlSink(str(path), truncate=False).write({"new": 2})
        kept = path.read_text()
        ev.JsonlSink(str(path)).write({"new": 3})
        fresh = path.read_text()
        w = ev.TelemetryWriter(str(tmp_path / f"{pkg}_w.jsonl"),
                               run_id="writer-9")
        w.write_manifest(kind="test")
        w.emit("thing", n=1)
        w.close()
        recs = _stream(tmp_path / f"{pkg}_w.jsonl")
        out[pkg] = (kept, fresh, w.run_id,
                    [(r["event"], r.get("run_id")) for r in recs])
    assert out["port"] == out["jax"]
    assert out["port"][0] == '{"old": 1}\n{"new": 2}\n'
    assert out["port"][2] == "writer-9"


def test_heartbeat_callback_source(tmp_path):
    """``heartbeat_callback(source=...)`` is accepted and ignored, as in
    the JAX package: the callback beats the lease with the queue depth."""
    depths = {}
    for pkg, sup in (("jax", jsup), ("port", tsup)):
        path = str(tmp_path / pkg / "w000.json")
        os.makedirs(os.path.dirname(path))
        cb = sup.WorkerLease(path, interval=0.0).heartbeat_callback(
            source=object())
        cb(5)
        with open(path) as f:
            depths[pkg] = json.load(f)["queue_depth"]
    assert depths == {"jax": 5, "port": 5}


def _stub_argv(i, n, g, s):
    return [sys.executable, "-c", "pass"]


def test_fleet_supervisor_heartbeat_interval(tmp_path):
    """Stored, never read, in both packages."""
    for pkg, sup in (("jax", jsup), ("port", tsup)):
        f = sup.FleetSupervisor(str(tmp_path / pkg), _stub_argv,
                                heartbeat_interval=1.25)
        assert f.heartbeat_interval == 1.25
        assert sup.FleetSupervisor(str(tmp_path / f"{pkg}2"),
                                   _stub_argv).heartbeat_interval == 0.5


@pytest.mark.parametrize("stagger", [True, False])
def test_serve_fleet_stagger(tmp_path, stagger):
    """``stagger=False`` spawns every replica at once; the default spawns
    the canary first and defers the rest: the same sets in both
    packages."""
    got = {}
    for pkg, sup in (("jax", jsup), ("port", tsup)):
        f = sup.ServeFleetSupervisor(str(tmp_path / pkg), _stub_argv,
                                     workers=3, stagger=stagger)
        try:
            f._spawn_set(3, kind="spawn")
            got[pkg] = (sorted(f._procs), [i for i, _ in f._deferred])
        finally:
            for w in f._procs.values():
                w.proc.wait(timeout=30)
    assert got["port"] == got["jax"]
    assert got["port"] == (([0, 1, 2], []) if not stagger
                           else ([0], [1, 2]))


# -- fault V2: Params, lda_math, mesh, base ---------------------------------
# every field up to seed, by position: the online-VB knobs sit between
# checkpoint_interval and seed in both packages
_PARAMS_ARGS = ("books", 7, 30, 2.0, 1.5, 1000, "a b", "online", None, 5,
                512.0, 0.7, 50.0, 32, "fixed", 3, 1, 0.01)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_params_bind_the_same_fields(how):
    """A call past ``checkpoint_interval`` binds the same fields in both
    packages, and both hash to the same config JSON."""
    names = [f.name for f in dataclasses.fields(jconfig.Params)]
    kw = dict(zip(names, _PARAMS_ARGS))
    j, t = ((P(*_PARAMS_ARGS) if how == "positional" else P(**kw))
            for P in (jconfig.Params, tconfig.Params))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.tau0, t.kappa, t.gamma_shape, t.batch_size, t.sampling,
            t.seed, t.min_doc_freq) == (512.0, 0.7, 50.0, 32, "fixed", 3, 1)
    assert json.loads(t.to_json()) == json.loads(j.to_json())


def _segments_problem():
    rng = np.random.default_rng(4)
    k, t, b = 5, 400, 12
    eb_tok = rng.random((t, k)).astype(np.float32) + 0.01
    cts = rng.integers(0, 5, t).astype(np.float32)
    seg = np.sort(rng.integers(0, b, t)).astype(np.int32)
    alpha = np.full((k,), 0.2, np.float32)
    return eb_tok, cts, seg, alpha, np.ones((b, k), np.float32)


def _norm(g):
    g = np.asarray(g, np.float64)
    return g / g.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_segments_reduce_fn_then_freeze(how):
    """``reduce_fn`` comes before ``freeze`` in both packages: a doubling
    reduction (two equal token shards) under per-document convergence,
    passed by position and by keyword."""
    arrays = _segments_problem()

    def run(lda, conv):
        xs = [conv(a) for a in arrays]
        double = lambda c: c + c  # noqa: E731
        if how == "positional":
            return lda.gamma_fixed_point_segments(*xs, 100, 1e-3, double,
                                                  True)[0]
        return lda.gamma_fixed_point_segments(*xs, 100, 1e-3,
                                              reduce_fn=double,
                                              freeze=True)[0]

    want = run(jlda, jnp.asarray)
    got = run(tlda, torch.from_numpy)
    plain = tlda.gamma_fixed_point_segments(
        *[torch.from_numpy(a) for a in arrays], 100, 1e-3, freeze=True)[0]
    np.testing.assert_allclose(_norm(got.numpy()), _norm(want), atol=1e-4)
    assert not np.allclose(got.numpy(), plain.numpy())   # the reduction ran


def _padded_problem(b=10, l=64, k=5, v=300, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    cts = rng.integers(1, 6, (b, l)).astype(np.float32)
    cts[:, -7:] = 0.0
    cts[b // 2] = 0.0                          # an empty doc
    eb = rng.random((k, v)).astype(np.float32) + 0.05
    return ids, cts, eb, np.full((k,), 0.2, np.float32), np.ones(
        (b, k), np.float32)


def _padded_call(lda, sparse, conv, fn, backend, how):
    ids, cts, eb, alpha, g0 = _padded_problem()
    batch = sparse.DocTermBatch(conv(ids), conv(cts))
    f = getattr(lda, fn)
    if how == "positional":
        return np.asarray(f(batch, conv(eb), conv(alpha), conv(g0), 100,
                            1e-3, backend))
    return np.asarray(f(batch, conv(eb), conv(alpha), conv(g0),
                        max_inner=100, tol=1e-3, backend=backend))


@pytest.mark.parametrize("how", ["positional", "keyword"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("fn", ["infer_gamma", "topic_inference"])
def test_gamma_backend_matches_jax(fn, backend, how):
    """``backend`` in both packages: "xla" is the plain whole-batch loop,
    "pallas" the E-step kernel (interpret mode in JAX, the kernel's plain
    version in the port, on the CPU); the E-step kernel's per-tile stop
    is held to 5e-3 of the normalized rows, as the kernel tests hold it."""
    want = _padded_call(jlda, jsparse, jnp.asarray, fn, backend, how)
    got = _padded_call(tlda, tsparse, torch.from_numpy, fn, backend, how)
    np.testing.assert_allclose(_norm(got), _norm(want),
                               atol=1e-4 if backend == "xla" else 5e-3)


@pytest.mark.parametrize("env,want", [(None, "pallas"), ("xla", "xla"),
                                      ("pallas", "pallas")])
def test_gamma_backend_auto_and_env(monkeypatch, env, want):
    """"auto" takes ``STC_GAMMA_BACKEND`` when set, else the E-step
    kernel (which on a CPU tensor runs its plain version): it routes to
    the same loop as the backend it resolves to, and an unknown backend
    raises in both packages."""
    if env is None:
        monkeypatch.delenv("STC_GAMMA_BACKEND", raising=False)
    else:
        monkeypatch.setenv("STC_GAMMA_BACKEND", env)
    calls = []
    for name in ("gamma_fixed_point", "gamma_fixed_point_batch"):
        real = getattr(tlda, name)
        monkeypatch.setattr(tlda, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    got = _padded_call(tlda, tsparse, torch.from_numpy, "infer_gamma",
                       "auto", "keyword")
    assert calls == ["gamma_fixed_point" if want == "pallas"
                     else "gamma_fixed_point_batch"]
    monkeypatch.delenv("STC_GAMMA_BACKEND", raising=False)
    same = _padded_call(tlda, tsparse, torch.from_numpy, "infer_gamma",
                        want, "keyword")
    np.testing.assert_array_equal(got, same)
    for lda, sparse, conv in ((jlda, jsparse, jnp.asarray),
                              (tlda, tsparse, torch.from_numpy)):
        with pytest.raises(ValueError, match="unknown gamma backend"):
            _padded_call(lda, sparse, conv, "topic_inference", "mosaic",
                         "keyword")


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_initialize_distributed_coordinator_address(tmp_path, how):
    """``coordinator_address`` by position and by keyword: no-op without
    it, partial arguments raise in both packages; the port joins a
    one-rank gloo group through it."""
    for mesh in (jmesh, tmesh):
        if how == "positional":
            assert mesh.initialize_distributed(None, None, None) is None
            with pytest.raises(ValueError, match="coordinator_address"):
                mesh.initialize_distributed(None, 2, 0)
        else:
            assert mesh.initialize_distributed(
                coordinator_address=None) is None
            with pytest.raises(ValueError, match="coordinator_address"):
                mesh.initialize_distributed(coordinator_address=None,
                                            num_processes=2, process_id=0)
    init = f"file://{tmp_path / 'rendezvous'}"
    assert not torch.distributed.is_initialized()
    try:
        if how == "positional":
            tmesh.initialize_distributed(init, 1, 0, backend="gloo",
                                         device="cpu")
        else:
            tmesh.initialize_distributed(coordinator_address=init,
                                         num_processes=1, process_id=0,
                                         backend="gloo", device="cpu")
        assert torch.distributed.get_world_size() == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_gather_token_rows_idx(how):
    """``gather_token_rows(table, idx)`` by position and by keyword."""
    rng = np.random.default_rng(2)
    table = rng.random((50, 4)).astype(np.float32)
    idx = rng.integers(0, 50, 33).astype(np.int32)
    got, want = (
        np.asarray(base.gather_token_rows(conv(table), conv(idx))
                   if how == "positional"
                   else base.gather_token_rows(table=conv(table),
                                               idx=conv(idx)))
        for base, conv in ((tbase, torch.from_numpy), (jbase, jnp.asarray)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


# -- signatures --------------------------------------------------------------
# every callable V1 and V2 repaired, as (port, JAX); each port parameter the JAX
# package lacks is a deliberate difference, listed with its reason
# (ROADMAP.md, "Deliberate differences from the JAX package so far")
_DEVICE = "entry points take the torch device= (North star)"
SIGNATURES = {
    "CountVectorizer": (tpipeline.CountVectorizer.__init__,
                        jpipeline.CountVectorizer.__init__, {}),
    "count_terms_parallel": (tvocab.count_terms_parallel,
                             jvocab.count_terms_parallel, {}),
    "merge_term_counts_multihost": (tvocab.merge_term_counts_multihost,
                                    jvocab.merge_term_counts_multihost, {}),
    "build_vocab_multihost": (tvocab.build_vocab_multihost,
                              jvocab.build_vocab_multihost, {}),
    "load_reference_model": ("models.reference_import.load_reference_model",
                             None, {"device": _DEVICE}),
    "save_reference_model": ("models.reference_export.save_reference_model",
                             None, {}),
    "preprocess_documents": ("utils.native.preprocess_documents", None, {}),
    "native_available": ("utils.native.native_available", None, {}),
    "telemetry.configure": (ttelemetry.configure, jtelemetry.configure,
                            {"device": _DEVICE}),
    "configure_shipping": (ttransport.configure_shipping,
                           jtransport.configure_shipping, {}),
    "JsonlSink": (tevents.JsonlSink.__init__, jevents.JsonlSink.__init__,
                  {}),
    "TelemetryWriter": (tevents.TelemetryWriter.__init__,
                        jevents.TelemetryWriter.__init__, {}),
    "heartbeat_callback": (tsup.WorkerLease.heartbeat_callback,
                           jsup.WorkerLease.heartbeat_callback, {}),
    "FleetSupervisor": (tsup.FleetSupervisor.__init__,
                        jsup.FleetSupervisor.__init__, {}),
    "ServeFleetSupervisor": (tsup.ServeFleetSupervisor.__init__,
                             jsup.ServeFleetSupervisor.__init__, {}),
    "Params": ("config.Params", None, {}),
    "gamma_fixed_point_segments": (
        "ops.lda_math.gamma_fixed_point_segments", None,
        {"with_iters": "each row's iterations, for the per-document "
                       "kernel's checks"}),
    "infer_gamma": ("ops.lda_math.infer_gamma", None, {}),
    "topic_inference": ("ops.lda_math.topic_inference", None, {}),
    "initialize_distributed": (
        "parallel.mesh.initialize_distributed", None,
        {"backend": "the torch.distributed backend, nccl or gloo "
                    "(--dist-backend)",
         "device": _DEVICE}),
    "gather_token_rows": ("models.base.gather_token_rows", None, {}),
}


def _resolve(name):
    import importlib

    mod, attr = name.rsplit(".", 1)
    return (getattr(importlib.import_module(
                f"spark_text_clustering_tpu_torch.{mod}"), attr),
            getattr(importlib.import_module(
                f"spark_text_clustering_tpu.{mod}"), attr))


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_matches_jax(name):
    """The port's parameters are the JAX package's (names, order, kinds,
    defaults), plus only the listed deliberate differences."""
    port, jax_fn, extra = SIGNATURES[name]
    if isinstance(port, str):
        port, jax_fn = _resolve(port)
    got = [p for p in _params(port) if p[0] not in extra]
    assert got == _params(jax_fn)
    assert {p[0] for p in _params(port)} - {p[0] for p in got} == set(extra)
