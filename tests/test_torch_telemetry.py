"""The port's telemetry core held against the JAX package's.

The copied modules (registry, names, tracing, prometheus) must behave as
the JAX package's on the same calls.  Then ``train``, ``score``,
``stream-score`` and ``stream-train`` run through both CLIs in this
process on the same six small books with ``--telemetry-file``: the JAX
CLI on a one-device mesh, the port's with ``--device cpu``.  The JAX
package's own ``metrics summarize --json`` reads both streams, and they
must carry the same manifest keys, ``config_hash``, event types and
metric names, the dispatch layer's families (``dispatch.*``,
``compile.*``, ``mem.<digest>.*``, the ``dispatch_executable`` events,
the ``compile_health`` section) included, with the digests masked (each
package hashes its own signatures).  The exceptions (``comparable``):
``collective.*``, which JAX counts when it traces its one-device mesh and
the port's 1x1 path never calls, and the dispatch names of what the port
does not do on the CPU (ROADMAP's deliberate differences of item 9b.1):
no cost estimates, code size or compile seconds where no hand-written
kernel launched and no kernel library loaded.  The NMF fit's label is the
port's tiled layout's (it tiles on every device; JAX only where its
kernel runs).  Both text front ends take their Python path (nltk), so no
g++ build is needed.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu.telemetry import metrics_cli as jmetrics
from spark_text_clustering_tpu.telemetry import names as jnames
from spark_text_clustering_tpu.telemetry import prometheus as jprom
from spark_text_clustering_tpu.telemetry import registry as jregistry
from spark_text_clustering_tpu.telemetry import tracing as jtracing
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import telemetry as ttelemetry
from spark_text_clustering_tpu_torch.telemetry import events as tevents
from spark_text_clustering_tpu_torch.telemetry import names as tnames
from spark_text_clustering_tpu_torch.telemetry import prometheus as tprom
from spark_text_clustering_tpu_torch.telemetry import registry as tregistry
from spark_text_clustering_tpu_torch.telemetry import tracing as ttracing
from spark_text_clustering_tpu_torch.utils import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "spark_text_clustering_tpu_torch")
K = 3
STREAM_FLAGS = ["--poll-interval", "0.01", "--idle-timeout", "0.2"]


# ---- the copied modules ------------------------------------------------
def _drive_registry(reg):
    rng = np.random.default_rng(3)
    for _ in range(40):
        reg.counter("ledger.commits").inc()
        reg.counter("resilience.retries").inc(int(rng.integers(0, 4)))
        reg.gauge("stream.queue_depth").set(float(rng.integers(0, 9)))
        reg.histogram("stream.score.micro_batch_seconds").observe(
            float(rng.lognormal(-3, 1)))
        reg.histogram("span.phase.train.seconds").observe(
            float(rng.uniform(0, 2)))
        reg.histogram("custom.sizes", [1, 10, 100]).observe(
            float(rng.integers(0, 200)))
    return reg


def test_registry_snapshot_equals_jax():
    """The same calls give the same snapshot, quantiles and buckets
    included."""
    t = _drive_registry(tregistry.MetricRegistry())
    j = _drive_registry(jregistry.MetricRegistry())
    assert t.snapshot() == j.snapshot()
    assert t.snapshot(include_buckets=True) == j.snapshot(
        include_buckets=True)
    h_t = t.histogram("stream.score.micro_batch_seconds")
    h_j = j.histogram("stream.score.micro_batch_seconds")
    for q in (0, 25, 50, 90, 95, 99, 100):
        assert h_t.percentile(q) == h_j.percentile(q)


@pytest.mark.parametrize("buckets", [False, True])
def test_prometheus_exposition_byte_equal(buckets):
    snap = _drive_registry(jregistry.MetricRegistry()).snapshot(
        include_buckets=buckets)
    labels = {"replica": "0"}
    assert tprom.render(snap, labels, buckets=buckets) == jprom.render(
        snap, labels, buckets=buckets)
    assert tprom.render(snap) == jprom.render(snap)


def test_names_equal_jax():
    """The port declares exactly the JAX package's names: it emits
    JAX's, and none of its own."""
    assert tnames.METRICS == jnames.METRICS
    assert tnames.PREFIXES == jnames.PREFIXES
    assert tnames.families() == jnames.families()


@pytest.mark.parametrize("wire", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "garbage", "", None,
])
def test_tracing_parse_and_format_equal_jax(wire):
    t, j = ttracing.parse(wire), jtracing.parse(wire)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.format() == j.format() == wire
        assert t.to_fields() == j.to_fields()
        assert ttracing.parse(j.format()).format() == t.format()
    minted = jtracing.mint(sampled=True)
    assert ttracing.parse(minted.format()).to_fields() == minted.to_fields()


# ---- the CLIs, both packages -------------------------------------------
def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_main(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def port_main(argv):
    return tcli.main([*argv, "--device", "cpu"])


@contextlib.contextmanager
def python_text_paths():
    """Both text front ends on their Python (nltk) path, the JAX CLI's
    meshes on as many CPU devices as asked for, and the SIGTERM handler
    the JAX stream verbs install put back."""
    import jax

    from spark_text_clustering_tpu.parallel import mesh as jmesh

    make_mesh = jmesh.make_mesh

    def small_mesh(data_shards=None, model_shards=1, devices=None):
        if devices is None and data_shards is not None:
            devices = jax.devices("cpu")[: data_shards * model_shards]
        return make_mesh(data_shards, model_shards, devices=devices)

    old = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline.TextPreprocessor, "_use_native",
                   lambda self: False)
        mp.setattr(jmesh, "make_mesh", small_mesh)
        mp.setattr(tnative, "_lib", None)
        mp.setattr(tnative, "_tried", True)
        mp.setattr(tnative, "_error", "the Python text path, for this test")
        try:
            yield
        finally:
            signal.signal(signal.SIGTERM, old)


def summarize(path):
    """The JAX package's ``metrics summarize --json`` of one stream."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jmetrics.cmd_summarize(argparse.Namespace(run=path, json=True))
    assert rc == 0
    return json.loads(out.getvalue())


_DIGEST = re.compile(r"\b(dispatch|mem|compile)\.[0-9a-f]{10}\.")
_KIND = re.compile(r"^(counter|gauge|hist)\.")
# the dispatch names the port writes only where a call launched a
# hand-written kernel (cost, code size) or loaded its library (compile
# seconds): never on the CPU, where JAX's XLA estimates every call
_KERNEL_ONLY = re.compile(
    r"^(dispatch\.<digest>\.(est_\w+|device_\w+_total)"
    r"|mem\.<digest>\.code_bytes|compile\.<digest>\.compile_seconds)$")
# the port's label where it takes another layout on the CPU
PORT_LABELS = {"nmf.fused_chunk": "nmf.packed_chunk"}


def masked(name):
    """``name`` with its digest masked and a port-only label renamed."""
    name = _DIGEST.sub(r"\1.<digest>.", name)
    for port, jax_label in PORT_LABELS.items():
        name = name.replace(f".{port}.", f".{jax_label}.")
    return name


def comparable(names, collectives=False):
    """Metric names with digests masked, less the dispatch names of kernel
    launches (``_KERNEL_ONLY``) and, on 1x1, ``collective.*`` and the
    calls' collective bytes."""
    keep = set()
    for name in names:
        name = masked(name)
        inner = _KIND.sub("", name)
        if _KERNEL_ONLY.match(inner) or (not collectives and (
                inner.startswith("collective.")
                or inner.endswith(".collective_bytes"))):
            continue
        keep.add(name)
    return keep


def event_types(path):
    return {e["event"] for e in tevents.read_events(path)}


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry_books")
    stop = chip_smoke.en_books_dir(7, str(root), n_books=6,
                                   words=(300, 1500))
    books = str(root / "books")
    for i, name in enumerate(sorted(os.listdir(books))):
        os.utime(os.path.join(books, name), (1e9 + i, 1e9 + i))
    return str(root), books, stop


def _start_state(books, stop, path):
    """One random EM start (n_wk, n_dk) over the CLI's TF-IDF rows, written
    by the JAX package's checkpoint writer, so both CLIs' fits start
    alike."""
    from spark_text_clustering_tpu.models.persistence import (
        save_train_state,
    )
    from spark_text_clustering_tpu_torch import pipeline as tpipeline
    from spark_text_clustering_tpu_torch.utils.readers import read_text_dir

    sw = tcli._load_stop_words(stop)
    ds = {"texts": [d.text for d in read_text_dir(books)]}
    ds = tpipeline.TextPreprocessor(stop_words=sw).transform(ds)
    ds = tpipeline.CountVectorizer().fit(ds).transform(ds)
    ds = tpipeline.IDF(device="cpu").fit(ds).transform(ds)
    rows = [(i, w) for i, w in ds["rows"] if len(i)]
    rng = np.random.default_rng(17)
    n_wk = np.zeros((K, len(ds["vocab"])), np.float32)
    n_dk = np.zeros((len(rows), K), np.float32)
    for d, (ids, w) in enumerate(rows):
        phi = rng.exponential(size=(len(ids), K)).astype(np.float32)
        wphi = w[:, None] * phi / phi.sum(1, keepdims=True)
        n_dk[d] = wphi.sum(0)
        np.add.at(n_wk.T, ids, wphi)
    save_train_state(path, 0, n_wk=n_wk, n_dk=n_dk)


@pytest.fixture(scope="module")
def runs(books):
    """Each verb through each CLI with ``--telemetry-file``: ``{verb:
    {"jax": (rc, stdout, stream), "port": ...}}``.  Each package runs in
    the same working dir, renamed after it, so both hash the same
    checkpoint paths into ``config_hash``; both fits resume from one
    start."""
    root, book_dir, stop = books
    work = os.path.join(root, "work")
    out = {}
    with python_text_paths():
        start = os.path.join(root, "start", "em_state.npz")
        _start_state(book_dir, stop, start)
        for name, main in (("jax", jax_main), ("port", port_main)):
            os.makedirs(os.path.join(work, "tck"))
            shutil.copy(start, os.path.join(work, "tck"))
            models = os.path.join(work, "m")

            def go(key, argv):
                path = os.path.join(work, f"{key}.jsonl")
                rc, so, se = run(main, [key.split(":")[0], *argv,
                                        "--telemetry-file", path])
                assert rc == 0, (name, key, se[-2000:])
                out.setdefault(key, {})[name] = (
                    rc, so, os.path.join(root, name, f"{key}.jsonl"))

            go("train", ["--books", book_dir, "--stop-words", stop,
                         "--k", str(K), "--max-iterations", "3",
                         "--checkpoint-dir", os.path.join(work, "tck"),
                         "--resume", "--models-dir", models,
                         "--data-shards", "1"])
            (saved,) = os.listdir(models)
            model = os.path.join(models, saved)
            for algo in ("online", "nmf"):
                go(f"train:{algo}", [
                    "--books", book_dir, "--stop-words", stop, "--k", str(K),
                    "--max-iterations", "3", "--algorithm", algo,
                    "--models-dir", os.path.join(work, algo),
                    "--data-shards", "1"])
            go("score", ["--books", book_dir, "--stop-words", stop,
                         "--model", model,
                         "--output-dir", os.path.join(work, "o")])
            go("stream-score", ["--watch-dir", book_dir, "--stop-words", stop,
                                "--model", model, "--checkpoint-dir",
                                os.path.join(work, "sck"), "--output-dir",
                                os.path.join(work, "so"),
                                "--max-files-per-trigger", "2",
                                *STREAM_FLAGS])
            go("stream-train", ["--watch-dir", book_dir, "--stop-words", stop,
                                "--k", str(K), "--hash-features", "1024",
                                "--checkpoint-dir", os.path.join(work, "ck"),
                                "--checkpoint-interval", "2",
                                "--max-files-per-trigger", "2",
                                "--models-dir", os.path.join(work, "sm"),
                                *STREAM_FLAGS])
            os.rename(work, os.path.join(root, name))
    return out


VERBS = ["train", "train:online", "train:nmf", "score", "stream-score",
         "stream-train"]


@pytest.mark.parametrize("verb", VERBS)
def test_manifest_keys_and_config_hash_equal_jax(runs, verb):
    j, t = (summarize(runs[verb][n][2]) for n in ("jax", "port"))
    jm, tm = j["manifest"], t["manifest"]
    assert set(tm) == set(jm)
    assert tm.get("config_hash") == jm.get("config_hash")
    assert tm["kind"] == jm["kind"] == verb.split(":")[0]
    assert tm["backend"] == "cpu"
    assert (tm["process_index"], tm["process_count"]) == (0, 1)


@pytest.mark.parametrize("verb", VERBS)
def test_event_types_equal_jax(runs, verb):
    j, t = (event_types(runs[verb][n][2]) for n in ("jax", "port"))
    assert t == j


@pytest.mark.parametrize("verb", VERBS)
def test_metric_names_equal_jax(runs, verb):
    j, t = (summarize(runs[verb][n][2]) for n in ("jax", "port"))
    # the port's streaming scorer sizes each chunk at its own longest
    # document, where JAX pins the first trigger's width (ROADMAP's
    # deliberate differences, the stream fleet): a second width is a
    # second signature, so its sentinel counts a retrace JAX's does not
    extra = {"counter.compile.retraces"} if verb == "stream-score" else set()
    assert comparable(t["metrics"]) - extra == comparable(j["metrics"])
    assert set(t) == set(j)


def test_train_corpus_and_loglik_equal_jax(runs):
    """``corpus.*`` exactly, ``train_fit``'s log-likelihood within 1e-4
    relative (the CLI's band), 3 ``train_iteration`` events, and the
    average the CLI prints is the stream's total over the documents."""
    j, t = (summarize(runs["train"][n][2]) for n in ("jax", "port"))
    for key in ("corpus.documents", "corpus.tokens", "corpus.vocab_width"):
        assert t["metrics"][key] == j["metrics"][key]
    ll_t = t["metrics"]["train.em.log_likelihood"]
    assert ll_t == pytest.approx(j["metrics"]["train.em.log_likelihood"],
                                 rel=1e-4)
    assert t["metrics"]["events.train_iteration.count"] == 3
    (line,) = [x for x in runs["train"]["port"][1].splitlines()
               if "average log likelihood" in x]
    assert float(line.split(":")[1]) == pytest.approx(
        ll_t / t["metrics"]["corpus.documents"], rel=1e-12)


def test_stream_train_commits_and_micro_batches(runs):
    """One ``micro_batch`` event a trigger, and ``ledger.commits`` equal
    to the records of the trainer's ledger, as in the JAX stream."""
    for name in ("jax", "port"):
        m = summarize(runs["stream-train"][name][2])["metrics"]
        ck = os.path.join(os.path.dirname(runs["stream-train"][name][2]),
                          "ck", "epochs.jsonl")
        with open(ck) as f:
            records = [json.loads(line) for line in f]
        assert m["counter.ledger.commits"] == len(records), name
        assert m["events.micro_batch.count"] == 3, name


def test_memory_sample_marks_the_cpu_unavailable(runs):
    events = tevents.read_events(runs["score"]["port"][2])
    (sample,) = [e for e in events if e["event"] == "memory_sample"]
    assert sample["device"] == "unavailable" and sample["host_rss_bytes"] > 0
    snap = events[-1]["snapshot"]
    assert snap["counters"]["mem.device_stats_unavailable"] == 1
    assert not any(k.startswith("mem.device.") for k in snap["gauges"])


def test_online_and_nmf_fits_report_as_jax_does(runs):
    """The online and NMF fits' ``train_fit`` fields and handoff pair:
    the same numbers as JAX's where they are counts of the run's shape."""
    for algo, keys in (("online", ("k", "vocab_width", "docs", "iterations",
                                   "batch_size")),
                       ("nmf", ("k", "vocab_width", "docs", "iterations"))):
        j, t = (summarize(runs[f"train:{algo}"][n][2])["metrics"]
                for n in ("jax", "port"))
        for key in keys:
            assert t[f"train.{algo}.{key}"] == j[f"train.{algo}.{key}"], key
        assert t["counter.handoff.downloads"] == 1
        assert t["gauge.handoff.deferred_bytes"] == K * t[
            f"train.{algo}.vocab_width"] * 4


def test_every_stream_ends_with_the_registry(runs):
    for verb in VERBS:
        events = tevents.read_events(runs[verb]["port"][2])
        assert events[0]["event"] == "manifest"
        assert events[-1]["event"] == "registry"
        assert events[-1]["process_index"] == 0


def test_exit_2_writes_the_registry(tmp_path):
    """A run that fails after its stream opened (no model to score)
    still ends the stream with a manifest and the registry."""
    path = str(tmp_path / "t.jsonl")
    rc, _, se = run(port_main, ["score", "--books", str(tmp_path),
                                "--models-dir", str(tmp_path / "none"),
                                "--telemetry-file", path])
    assert rc == 2, se
    events = tevents.read_events(path)
    assert [e["event"] for e in events] == ["manifest", "registry"]
    assert not ttelemetry.enabled()


def test_flag_absent_or_present_saves_the_same_model(books, tmp_path):
    """Telemetry observes and never steers: a CPU fit with the flag saves
    the same arrays, bit for bit, as one without it."""
    _, book_dir, stop = books
    arrays = []
    with python_text_paths():
        for i, extra in enumerate(
                ([], ["--telemetry-file", str(tmp_path / "t.jsonl")])):
            models = str(tmp_path / f"m{i}")
            rc, _, se = run(port_main, [
                "train", "--books", book_dir, "--stop-words", stop,
                "--k", str(K), "--max-iterations", "3",
                "--models-dir", models, *extra])
            assert rc == 0, se
            (saved,) = os.listdir(models)
            with np.load(os.path.join(models, saved, "arrays.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
    assert arrays[0].keys() == arrays[1].keys()
    for key in arrays[0]:
        assert np.array_equal(arrays[0][key], arrays[1][key]), key


def test_trace_context_rides_micro_batches_and_ledger(books, tmp_path,
                                                      monkeypatch):
    """With a spawner's ``STC_TRACE``, every ``micro_batch`` event and
    every committed ledger record carry its trace id; each record owns a
    child span of its own."""
    _, book_dir, stop = books
    parent = jtracing.mint(sampled=True)
    monkeypatch.setenv("STC_TRACE", parent.format())
    path = str(tmp_path / "t.jsonl")
    ck = str(tmp_path / "ck")
    try:
        with python_text_paths():
            rc, _, se = run(port_main, [
                "stream-train", "--watch-dir", book_dir, "--stop-words",
                stop, "--k", str(K), "--hash-features", "1024",
                "--checkpoint-dir", ck, "--checkpoint-interval", "1",
                "--max-files-per-trigger", "3", "--models-dir",
                str(tmp_path / "m"), "--telemetry-file", path,
                *STREAM_FLAGS])
    finally:
        ttracing.install(None)
    assert rc == 0, se
    events = tevents.read_events(path)
    batches = [e for e in events if e["event"] == "micro_batch"]
    assert len(batches) == 2
    assert {e["trace_id"] for e in batches} == {parent.trace_id}
    (adopt,) = [e for e in events if e["event"] == "trace_adopt"]
    assert adopt["parent_span_id"] == parent.span_id
    with open(os.path.join(ck, "epochs.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records and all(r["trace"]["trace_id"] == parent.trace_id
                           for r in records)
    assert all(r["trace"]["parent_span_id"] == adopt["span_id"]
               for r in records)
    commits = [e for e in events if e["event"] == "ledger_commit"]
    assert [c["span_id"] for c in commits] == [
        r["trace"]["span_id"] for r in records]


def test_grid_train_writes_a_stream_a_rank(books, tmp_path):
    """A 2x1 gloo ``train --data-shards 2`` writes ``-p0`` and ``-p1``
    with the grid's process fields, each counting its real collectives,
    and the JAX package's ``metrics merge`` folds them into one run."""
    _, book_dir, stop = books
    path = str(tmp_path / "t.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "train", "--books", book_dir, "--stop-words", stop, "--k", str(K),
         "--max-iterations", "3", "--models-dir", str(tmp_path / "m"),
         "--data-shards", "2", "--device", "cpu", "--telemetry-file", path],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not os.path.exists(path)
    paths = [str(tmp_path / f"t-p{r}.jsonl") for r in range(2)]
    for rank, p in enumerate(paths):
        man = tevents.read_events(p)[0]
        assert (man["process_index"], man["process_count"]) == (rank, 2)
        assert man["mesh_shape"] == {"data": 2, "model": 1}
        counters = tevents.read_events(p)[-1]["snapshot"]["counters"]
        assert counters["collective.psum_data.calls"] > 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jmetrics.cmd_merge(argparse.Namespace(
            runs=paths, json=True, skew_threshold=0.5, fail_on_skew=False))
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert [p["label"] for p in doc["processes"]] == ["p0", "p1"]
    assert doc["metrics"]["merge.counter.collective.psum_data.calls"][
        "processes"] == 2
    assert not doc["problems"]


def test_every_grid_rank_adopts_the_trace(books, tmp_path):
    """A 2x1 gloo ``stream-train`` under a spawner's ``STC_TRACE``: every
    rank adopts it, so each rank's ``micro_batch`` events carry its
    trace id and each rank's ``trace_adopt`` hangs off the spawner's
    span."""
    _, book_dir, stop = books
    parent = jtracing.mint(sampled=True)
    path = str(tmp_path / "t.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["STC_TRACE"] = parent.format()
    out = subprocess.run(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "stream-train", "--watch-dir", book_dir, "--stop-words", stop,
         "--k", str(K), "--hash-features", "1024", "--checkpoint-dir",
         str(tmp_path / "ck"), "--max-files-per-trigger", "3",
         "--models-dir", str(tmp_path / "m"), "--data-shards", "2",
         "--dist-backend", "gloo", "--device", "cpu", "--telemetry-file",
         path, *STREAM_FLAGS],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(2):
        events = tevents.read_events(str(tmp_path / f"t-p{rank}.jsonl"))
        batches = [e for e in events if e["event"] == "micro_batch"]
        assert len(batches) == 2, rank
        assert {e.get("trace_id") for e in batches} == {parent.trace_id}
        (adopt,) = [e for e in events if e["event"] == "trace_adopt"]
        assert adopt["parent_span_id"] == parent.span_id


@pytest.mark.parametrize("collector", ["up", "down, then replayed"])
def test_stc_ship_to_feeds_the_jax_collector(tmp_path, monkeypatch,
                                             collector):
    """With ``STC_SHIP_TO`` set, every record of the port's run stream
    reaches the JAX package's collector, which folds it into a stream
    equal to the local one.  A collector that is down gets nothing and
    loses nothing: the batches spool next to the stream, and the next
    shipper replays them in order."""
    import socket
    import threading

    from spark_text_clustering_tpu.telemetry import transport as jtransport
    from spark_text_clustering_tpu_torch.telemetry import transport

    collect_dir = str(tmp_path / "collect")
    server = jtransport.make_collector_server(
        jtransport.Collector(collect_dir))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    live = f"127.0.0.1:{server.server_address[1]}"
    if collector == "up":
        monkeypatch.setenv("STC_SHIP_TO", live)
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            monkeypatch.setenv("STC_SHIP_TO",
                               f"127.0.0.1:{s.getsockname()[1]}")
    path = str(tmp_path / "run" / "t.jsonl")
    try:
        ttelemetry.configure(path, device="cpu")
        ttelemetry.manifest(mesh={"data": 1, "model": 1}, kind="x")
        for i in range(300):
            ttelemetry.event("micro_batch", batch_id=i, docs=2)
        ttelemetry.count("ledger.commits", 3)
        ttelemetry.shutdown()
        if collector != "up":
            assert os.listdir(collect_dir) == []
            transport.configure_shipping(live, stream_path=path)
            transport.close_shipping()
    finally:
        ttelemetry.shutdown()
        server.shutdown()
        server.server_close()
    (name,) = os.listdir(collect_dir)
    with open(os.path.join(collect_dir, name)) as f:
        folded = [json.loads(line) for line in f]
    folded = [e for e in folded if e["event"] != "collect_batch"]
    for key in ("source_id", "collect_recv_ts"):
        folded[0].pop(key)
    assert folded == tevents.read_events(path)
    assert len(folded) == 302


# ---- the name test -----------------------------------------------------
_FACADE = ("count", "gauge", "observe")


def _metric_name_calls():
    """(file, line, name) of every ``telemetry.count/gauge/observe`` call
    in the port whose name is a literal (or an f-string, by its literal
    head)."""
    hits = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _FACADE
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "telemetry"
                        and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    name, dynamic = arg.value, False
                elif isinstance(arg, ast.JoinedStr):
                    head = arg.values[0] if arg.values else None
                    name = (head.value if isinstance(head, ast.Constant)
                            else "")
                    dynamic = True
                else:
                    continue        # a forwarded constant (retry._count)
                hits.append((os.path.relpath(path, REPO), node.lineno, name,
                             dynamic))
    return hits


def test_every_metric_name_is_declared():
    """The port's twin of the JAX package's lint rule STC004: every
    literal name the port passes to ``count`` / ``gauge`` / ``observe``
    is declared in ``names.METRICS``; an f-string's literal head is a
    declared prefix."""
    hits = _metric_name_calls()
    assert {path for path, _, _, _ in hits} >= {
        os.path.join("spark_text_clustering_tpu_torch", f) for f in (
            "cli.py", "streaming.py", "parallel/collectives.py",
            "parallel/mesh.py", "models/persistence.py", "utils/timing.py")}
    bad = []
    for path, line, name, dynamic in hits:
        ok = (any(name.startswith(p) for p in tnames.PREFIXES) if dynamic
              else tnames.declared(name) and tnames.is_valid_name(name))
        if not ok:
            bad.append(f"{path}:{line}: {name!r}")
    assert not bad, bad
    from spark_text_clustering_tpu_torch.resilience import ledger, quarantine
    from spark_text_clustering_tpu_torch.resilience import retry

    for const in (retry.RETRIES_COUNTER, retry.GIVEUPS_COUNTER,
                  retry.DEADLINE_GIVEUPS_COUNTER, ledger.COMMITS_COUNTER,
                  ledger.ROLLBACKS_COUNTER, ledger.COMPACTIONS_COUNTER,
                  quarantine.QUARANTINED_COUNTER,
                  quarantine.REPLAYED_COUNTER, quarantine.ARCHIVED_COUNTER):
        assert const in tnames.METRICS, const


# ---- the facade --------------------------------------------------------
def test_disabled_facade_records_nothing():
    import torch

    assert not ttelemetry.enabled()
    reg = ttelemetry.get_registry()
    before = reg.snapshot()
    x = torch.ones(3)
    assert ttelemetry.device_sync(x, "em_packed") is x
    assert ttelemetry.span("phase.x") is ttelemetry.spans.NOOP_SPAN
    ttelemetry.count("ledger.commits")
    ttelemetry.emit_fit("em", [0.1])
    assert ttelemetry.sample_memory("x") is None
    assert reg.snapshot() == before


def test_device_sync_on_the_cpu_counts_without_a_sync(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (_ for _ in ())
                        .throw(AssertionError("a sync on the CPU")))
    ttelemetry.configure(str(tmp_path / "t.jsonl"), device="cpu")
    try:
        ttelemetry.device_sync(torch.ones(2), "nmf")
        ttelemetry.device_sync(torch.ones(2), "nmf")
        snap = ttelemetry.get_registry().snapshot()
    finally:
        ttelemetry.shutdown()
    assert snap["counters"]["device_sync.nmf.calls"] == 2
    assert snap["histograms"]["device_sync.nmf.seconds"]["count"] == 2


def test_manifest_names_the_backend_as_jax_does(tmp_path):
    assert tevents.backend_fields("cpu") == {"backend": "cpu",
                                             "device_count": 1}
    path = str(tmp_path / "t.jsonl")
    ttelemetry.configure(path, device="cpu")
    ttelemetry.manifest(mesh={"data": 1, "model": 1}, kind="x")
    ttelemetry.shutdown()
    man = tevents.read_events(path)[0]
    assert man["backend"] == "cpu" and man["mesh_shape"] == {
        "data": 1, "model": 1}
    assert "device" not in man
