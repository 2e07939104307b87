"""The port's CLI and text front end held against the JAX package's.

Both CLIs run in this process on the CPU: the JAX CLI on a one-device
mesh (``--data-shards 1``), the port's with ``--device cpu`` (its kernels'
plain versions).  The JAX package's text preprocessing runs its Python
path (nltk), the reference the port's native library is held to; the
JAX package's own native build is never touched.  The corpus is
``chip_smoke.en_books_dir``'s recipe, cut to a few small books.
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

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models import online_lda as jonline
from spark_text_clustering_tpu.models.persistence import (
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.ops import tfidf as jtfidf
from spark_text_clustering_tpu.resilience import resume as jresume
from spark_text_clustering_tpu.utils import textproc as jtextproc
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import pipeline as tpipeline
from spark_text_clustering_tpu_torch.config import Params as TParams
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.models import online_lda as tonline
from spark_text_clustering_tpu_torch.models.persistence import (
    load_model as tload_model,
)
from spark_text_clustering_tpu_torch.ops import tfidf as ttfidf
from spark_text_clustering_tpu_torch.resilience import resume as tresume
from spark_text_clustering_tpu_torch.utils import native as tnative
from spark_text_clustering_tpu_torch.utils import textproc as ttextproc
from spark_text_clustering_tpu_torch.utils.readers import read_text_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
ITERS = 5


@pytest.fixture(scope="module")
def native_lib():
    """The port's text library, built once for this file (g++, ~1 min)."""
    tnative.build()
    tnative.load()
    return tnative


@contextlib.contextmanager
def jax_python_text():
    """The JAX package's TextPreprocessor on its Python (nltk) path, and
    its meshes on as many of the 8 virtual CPU devices as they ask for
    (the CLI's ``make_mesh`` takes every device by default)."""
    from spark_text_clustering_tpu.parallel import mesh as jmesh

    make_mesh = jmesh.make_mesh

    def small_mesh(data_shards=None, model_shards=1, devices=None):
        if devices is None and data_shards is not None:
            devices = jax.devices("cpu")[: data_shards * model_shards]
        return make_mesh(data_shards, model_shards, devices=devices)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline.TextPreprocessor, "_use_native",
                   lambda self: False)
        mp.setattr(jmesh, "make_mesh", small_mesh)
        yield


def run(main, argv):
    """(exit code, stdout, stderr) of ``main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_main(argv):
    """The JAX CLI's command without its process-wide compile cache."""
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def port_main(argv):
    return tcli.main([*argv, "--device", "cpu"])


_FLOAT = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")
_MILLIS = re.compile(r"\d{10,}")


def mask(text: str, paths=()) -> str:
    for path, name in paths:
        text = text.replace(path, name)
    return _MILLIS.sub("<ms>", _FLOAT.sub("<f>", text))


def report_of(out_dir):
    (name,) = os.listdir(out_dir)
    with open(os.path.join(out_dir, name), encoding="utf-8") as f:
        return f.read()


# ---- text front end ----------------------------------------------------
def _test_file_texts():
    """Every sentence-like string literal of the JAX package's text tests
    (``tests/test_textproc.py``, ``tests/test_native_textproc.py``)."""
    texts = []
    for name in ("test_textproc.py", "test_native_textproc.py"):
        with open(os.path.join(REPO, "tests", name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and " " in node.value.strip()):
                texts.append(node.value)
    return sorted(set(texts))


@pytest.fixture(scope="module")
def synthetic_book(tmp_path_factory):
    root = tmp_path_factory.mktemp("book")
    chip_smoke.en_books_dir(11, str(root), n_books=1, words=(4000, 4000))
    (doc,) = read_text_dir(str(root / "books"))
    return doc.text


STOP = frozenset({"the", "and", "The", "was", "nipuhono", "gupida"})


@pytest.mark.parametrize("stop", [frozenset(), STOP], ids=["no_stop", "stop"])
@pytest.mark.parametrize("lemmatize", [True, False],
                         ids=["lemma", "no_lemma"])
@pytest.mark.parametrize("source", ["test_texts", "synthetic_book"])
def test_front_end_tokens_match_jax_python_path(
    native_lib, synthetic_book, source, lemmatize, stop
):
    """The port's native tokens, and its Python path's, equal the JAX
    package's ``preprocess_document`` token for token (exact)."""
    texts = (_test_file_texts() if source == "test_texts"
             else [synthetic_book])
    assert texts
    opts = dict(stop_words=stop, lemmatize=lemmatize)
    want = [jtextproc.preprocess_document(t, **opts) for t in texts]
    assert native_lib.preprocess_documents(texts, **opts) == want
    assert [ttextproc.preprocess_document(t, **opts) for t in texts] == want
    pre = tpipeline.TextPreprocessor(stop_words=stop, lemmatize=lemmatize)
    assert pre.transform({"texts": texts})["tokens"] == want
    assert pre.last_backend == "native"


def test_native_stem_and_lemma_match_jax(native_lib):
    words = ["caresses", "ponies", "Holmes", "littl", "possibly", "was",
             "children", "running", "дома", "élégant", "s", "ing"]
    for w in words:
        assert native_lib.stem_native(w) == jtextproc.stem(w), w
        assert native_lib.lemma_native(w) == jtextproc.lemma(w), w


def test_python_backend_without_nltk_names_the_native_path(monkeypatch):
    """Where nltk is missing, the Python path's stemmer raises and names
    the native path; 'auto' with neither backend raises naming both."""
    import builtins

    real_import = builtins.__import__

    def no_nltk(name, *a, **k):
        if name == "nltk" or name.startswith("nltk."):
            raise ImportError("No module named 'nltk'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_nltk)
    ttextproc._stemmer.cache_clear()
    ttextproc.stem.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native"):
            ttextproc.stem("running")
        monkeypatch.setattr(tnative, "_error", "g++ not found")
        monkeypatch.setattr(tnative, "_tried", True)
        monkeypatch.setattr(tnative, "_lib", None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found.*nltk"):
            tpipeline.TextPreprocessor().transform({"texts": ["a b"]})
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tpipeline.TextPreprocessor(backend="native").transform(
                {"texts": ["a b"]})
    finally:
        ttextproc._stemmer.cache_clear()
        ttextproc.stem.cache_clear()


def test_native_build_is_keyed_and_lands_in_build_dir(native_lib):
    path = native_lib.lib_path()
    assert path.exists() and path.parent.name == "torch_kernels"
    assert path.name.startswith("textproc_") and path.suffix == ".so"
    assert native_lib.build() == 0.0        # built: nothing to do


# ---- hashing -------------------------------------------------------------
def _token_lists(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz") + list("éüßжфя日本語ö")
    vocab = ["".join(rng.choice(alphabet, int(rng.integers(0, 12))))
             for _ in range(400)]
    return [list(rng.choice(vocab, int(rng.integers(0, 80))))
            for _ in range(30)]


@pytest.mark.parametrize("num_features", [1 << 18, 1000, 7])
def test_hashing_matches_jax(num_features):
    """murmur3 (scalar and batch), bucket ids and HashingTF rows equal the
    JAX package's exactly, non-ASCII and empty tokens included."""
    docs = _token_lists(num_features)
    flat = sorted({t for d in docs for t in d})
    for t in flat[:100]:
        b = t.encode("utf-8")
        assert ttfidf.murmur3_32(b) == jtfidf.murmur3_32(b)
    np.testing.assert_array_equal(ttfidf.murmur3_32_batch(flat),
                                  jtfidf.murmur3_32_batch(flat))
    np.testing.assert_array_equal(ttfidf.hash_buckets(flat, num_features),
                                  jtfidf.hash_buckets(flat, num_features))
    got = ttfidf.hashing_tf_rows(docs, num_features)
    want = jtfidf.hashing_tf_rows(docs, num_features)
    assert len(got) == len(want)
    for (gi, gw), (wi, ww), doc in zip(got, want, docs):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
        gi1, gw1 = ttfidf.hashing_tf_ids(doc, num_features)
        np.testing.assert_array_equal(gi1, wi)
        np.testing.assert_array_equal(gw1, ww)
    ht = tpipeline.HashingTF(num_features).transform({"tokens": docs})
    assert ht["vocab"] is None and ht["num_features"] == num_features


@pytest.mark.parametrize("vocab", [
    [], ["h0"], [f"h{i}" for i in range(50)], ["a", "b", "c"],
    [f"h{i}" for i in range(49)] + ["x"], ["h0", "zz", "h2"],
])
def test_is_hashed_vocab_matches_jax(vocab):
    assert tpipeline.is_hashed_vocab(vocab) == jpipeline.is_hashed_vocab(vocab)


@pytest.mark.parametrize("vocab", [["b", "a", "c"], ["h0", "h1", "h2", "h3"]])
def test_make_vectorizer_matches_jax(vocab):
    docs = [["a", "c", "a", "zz"], [], ["b"], ["h1", "q"]]
    got = tpipeline.make_vectorizer(vocab)(docs)
    want = jpipeline.make_vectorizer(vocab)(docs)
    for (gi, gw), (wi, ww) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gw, np.asarray(ww))


def test_pipeline_stages_match_jax(native_lib, corpus):
    """Pipeline(TextPreprocessor, CountVectorizer, IDF) gives the JAX
    pipeline's vocabulary exactly and its TF-IDF rows within rtol 1e-6;
    with an LDA stage appended the port's PipelineModel scores every doc
    (distributions sum to 1 within 1e-5)."""
    books, stop = corpus
    sw = tcli._load_stop_words(stop)
    texts = {"texts": [d.text for d in read_text_dir(books)]}
    with jax_python_text():
        jfit = jpipeline.Pipeline([
            jpipeline.TextPreprocessor(stop_words=sw),
            jpipeline.CountVectorizer(), jpipeline.IDF()]).fit(texts)
        want = jfit.transform(texts)
    tstages = [tpipeline.TextPreprocessor(stop_words=sw),
               tpipeline.CountVectorizer(), tpipeline.IDF(device="cpu")]
    got = tpipeline.Pipeline(tstages).fit(texts).transform(texts)
    assert got["vocab"] == want["vocab"]
    for (gi, gw), (wi, ww) in zip(got["rows"], want["rows"], strict=True):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gw, ww, rtol=1e-6)
    lda = tpipeline.LDA(TParams(k=2, max_iterations=3,
                                token_layout="packed"), device="cpu")
    out = tpipeline.Pipeline([*tstages, lda]).fit(texts).transform(texts)
    dist = out["topic_distribution"]
    assert dist.shape == (10, 2)
    np.testing.assert_allclose(dist.sum(1), 1.0, atol=1e-5)


# ---- config and resume gate ------------------------------------------------
PARAM_CASES = {
    "default": {},
    "k7_seed3": dict(k=7, seed=3),
    "online_epoch": dict(algorithm="online", sampling="epoch"),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_params_json_and_config_hash_match_jax(case):
    kw = PARAM_CASES[case]
    t, j = TParams(**kw), JParams(**kw)
    assert t.to_json() == j.to_json()
    assert tresume.config_hash(t) == jresume.config_hash(j)
    # run length is not structural; k is
    assert tresume.config_hash(t.replace(max_iterations=999)) == \
        tresume.config_hash(t)
    assert tresume.config_hash(t.replace(k=t.k + 1)) != tresume.config_hash(t)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_meta_accepted_across_packages(tmp_path, writer):
    vocab = ["a", "b", "c"]
    kw = dict(k=4, seed=2, token_layout="packed", data_shards=1)
    t, j = TParams(**kw), JParams(**kw)
    fp = tresume.vocab_fingerprint(vocab)
    assert fp == jresume.vocab_fingerprint(vocab)
    if writer == "jax":
        jresume.write_resume_meta(str(tmp_path), j, fp)
        meta = tresume.validate_resume_meta(str(tmp_path), t, fp)
        with pytest.raises(tresume.ResumeMismatchError):
            tresume.validate_resume_meta(str(tmp_path), t.replace(k=5), fp)
    else:
        tresume.write_resume_meta(str(tmp_path), t, fp)
        meta = jresume.validate_resume_meta(str(tmp_path), j, fp)
        with pytest.raises(jresume.ResumeMismatchError):
            jresume.validate_resume_meta(str(tmp_path), j, fp + 1)
    assert meta["config_hash"] == tresume.config_hash(t)


# ---- the CLIs end to end ---------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten small books of chip_smoke's recipe and a stop-word file."""
    root = tmp_path_factory.mktemp("corpus")
    stop = chip_smoke.en_books_dir(5, str(root), n_books=10,
                                   words=(300, 1500))
    return str(root / "books"), stop


def _start_state(books, stop, base):
    """One random EM start (n_wk, n_dk) over the CLI's TF-IDF rows,
    written by the JAX package's checkpoint writer."""
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
    j_save_train_state(os.path.join(base, "em_state.npz"), 0,
                       n_wk=n_wk, n_dk=n_dk)


@pytest.fixture(scope="module")
def trained(native_lib, corpus, tmp_path_factory):
    """Both CLIs' ``train`` from one em_state.npz, copied into two
    checkpoint dirs: {"jax"|"port": (rc, stdout, stderr, model dir,
    checkpoint dir)}."""
    books, stop = corpus
    root = tmp_path_factory.mktemp("train")
    base = str(root / "start")
    _start_state(books, stop, base)
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        ckpt, models = str(root / f"ckpt_{name}"), str(root / f"m_{name}")
        shutil.copytree(base, ckpt)
        argv = ["train", "--books", books, "--stop-words", stop,
                "--k", str(K), "--models-dir", models,
                "--checkpoint-dir", ckpt, "--resume",
                "--token-layout", "packed", "--data-shards", "1",
                "--max-iterations", str(ITERS)]
        with jax_python_text():
            rc, so, se = run(main, argv)
        saved = os.listdir(models) if os.path.isdir(models) else []
        model = os.path.join(models, saved[0]) if len(saved) == 1 else None
        out[name] = (rc, so, se, model, ckpt)
    return out


def _avg_loglik(stdout):
    (line,) = [x for x in stdout.splitlines() if "average log likelihood" in x]
    return float(line.split(":")[1])


def test_train_matches_jax_cli(trained):
    """lam within rtol 1e-4 after 5 sweeps (the EM test's tolerance), the
    printed average log-likelihood within 1e-4 relative, and stdout equal
    line for line with numbers, times and paths masked."""
    (jrc, jout, jerr, jdir, jck), (trc, tout, terr, tdir, tck) = (
        trained["jax"], trained["port"])
    assert jrc == 0 and trc == 0, (jerr, terr)
    assert jdir and tdir
    with np.load(os.path.join(jdir, "arrays.npz")) as j, \
            np.load(os.path.join(tdir, "arrays.npz")) as t:
        np.testing.assert_allclose(t["lam"], j["lam"], rtol=1e-4)
        np.testing.assert_allclose(t["alpha"], j["alpha"], rtol=1e-6)
    for name in ("vocab.txt", "meta.json"):
        assert os.path.exists(os.path.join(tdir, name))
    with open(os.path.join(jdir, "vocab.txt"), encoding="utf-8") as f1, \
            open(os.path.join(tdir, "vocab.txt"), encoding="utf-8") as f2:
        assert f1.read() == f2.read()
    assert _avg_loglik(tout) == pytest.approx(_avg_loglik(jout), rel=1e-4)
    jm = mask(jout, [(jck, "<ckpt>"), (os.path.dirname(jdir), "<models>")])
    tm = mask(tout, [(tck, "<ckpt>"), (os.path.dirname(tdir), "<models>")])
    assert "resuming from checkpoint <ckpt>/em_state.npz" in tm
    assert tm.splitlines() == jm.splitlines()


def test_train_resume_meta_is_shared(trained, corpus):
    """Each CLI's resume_meta.json carries the same config hash and vocab
    fingerprint, and passes the other package's gate."""
    jck, tck = trained["jax"][4], trained["port"][4]
    with open(os.path.join(trained["port"][3], "vocab.txt"),
              encoding="utf-8") as f:
        vocab = f.read().split("\n")
    # argparse leaves the -1 defaults of the float flags as ints, in both
    # CLIs, and the hash sees the JSON
    kw = dict(input=corpus[0], k=K, token_layout="packed", data_shards=1,
              checkpoint_dir=tck, max_iterations=ITERS,
              doc_concentration=-1, topic_concentration=-1)
    fp = tresume.vocab_fingerprint(vocab)
    assert tresume.validate_resume_meta(jck, TParams(**kw), fp) is not None
    assert jresume.validate_resume_meta(tck, JParams(**kw), fp) is not None


SCORE_CASES = [("jax", False), ("jax", True), ("port", False), ("port", True)]


@pytest.mark.parametrize("saved_by,per_doc", SCORE_CASES,
                         ids=[f"{m}_{'per_doc' if p else 'batch'}"
                              for m, p in SCORE_CASES])
def test_score_matches_jax_cli(trained, corpus, tmp_path, saved_by, per_doc):
    """One saved model scored by both CLIs with --model: the reports are
    byte-identical with every float masked, and every distribution agrees
    within atol 1e-4 (the packed tolerance of test_torch_scoring)."""
    books, stop = corpus
    model = trained[saved_by][3]
    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_dir = str(tmp_path / name)
        argv = ["score", "--books", books, "--stop-words", stop,
                "--model", model, "--output-dir", out_dir]
        if per_doc:
            argv.append("--per-doc-convergence")
        with jax_python_text():
            rc, so, se = run(main, argv)
        assert rc == 0, se
        reports[name] = (report_of(out_dir), so)
    (jrep, jout), (trep, tout) = reports["jax"], reports["port"]
    assert mask(trep) == mask(jrep)
    assert mask(tout, [(str(tmp_path / "port"), "<o>")]) == \
        mask(jout, [(str(tmp_path / "jax"), "<o>")])
    dj = chip_smoke.report_distributions(jrep, K)
    dt = chip_smoke.report_distributions(trep, K)
    assert dj.shape == (10, K)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


def test_score_hashed_vocab_model_matches_jax(native_lib, corpus, tmp_path):
    """A model over the synthetic h0..hN vocabulary is scored through
    make_vectorizer's HashingTF branch by both CLIs, with equal reports
    (floats masked) and distributions within atol 1e-4."""
    books, stop = corpus
    v = 512
    rng = np.random.default_rng(3)
    model = lda_model_from_numpy(rng.gamma(1.0, 1.0, (K, v)) + 0.05,
                                 np.full(K, 0.5), 0.3,
                                 [f"h{i}" for i in range(v)], device="cpu")
    path = str(tmp_path / "LdaModel_EN_1")
    model.save(path)
    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_dir = str(tmp_path / name)
        with jax_python_text():
            rc, _, se = run(main, ["score", "--books", books, "--stop-words",
                                   stop, "--model", path,
                                   "--output-dir", out_dir])
        assert rc == 0, se
        reports[name] = report_of(out_dir)
    assert mask(reports["port"]) == mask(reports["jax"])
    np.testing.assert_allclose(
        chip_smoke.report_distributions(reports["port"], K),
        chip_smoke.report_distributions(reports["jax"], K), atol=1e-4)


def test_books_root_routes_through_lang_dirs(native_lib, corpus, tmp_path):
    """score --books-root <root> --lang FR reads <root>/French, as the
    JAX CLI (and LDALoader.scala) route it."""
    assert tcli.LANG_DIRS == jcli.LANG_DIRS
    books, stop = corpus
    root = tmp_path / "root"
    shutil.copytree(books, root / "French")
    models = str(tmp_path / "m")
    rc, _, se = run(port_main, [
        "train", "--books", books, "--stop-words", stop, "--lang", "FR",
        "--k", "2", "--max-iterations", "2", "--models-dir", models,
        "--token-layout", "packed"])
    assert rc == 0, se
    assert os.listdir(models)[0].startswith("LdaModel_FR_")
    out_dir = str(tmp_path / "o")
    rc, so, se = run(port_main, [
        "score", "--books-root", str(root), "--lang", "FR",
        "--stop-words", stop, "--models-dir", models, "--output-dir", out_dir])
    assert rc == 0, se
    report = report_of(out_dir)
    assert os.listdir(out_dir)[0].startswith("Result_FR_")
    assert report.count("Book's number:") == 10
    assert "Book's name: book_00.txt" in report
    rc, _, se = run(port_main, ["score", "--models-dir", models,
                                "--lang", "FR"])
    assert rc == 2 and "--books or --books-root" in se


@pytest.mark.parametrize("cmd", ["train", "score", "stream-score",
                                 "stream-train", "stream", "supervise"])
def test_cli_flags_and_defaults_match_jax(cmd):
    """Every flag of the JAX CLI's train, score, stream and supervise
    verbs, with its default, and the port's own: --device (default cuda;
    on supervise None, which passes no --device to the workers) and, on
    train, score and stream-train, --dist-backend (default by device);
    score also takes the grid bring-up flags train has.  ``stream`` has the JAX package's
    two maintenance verbs, with their flags."""
    def subparsers(parser):
        (sub,) = [a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction)]
        return sub.choices

    def flags(parser):
        return {(o, tuple(a.default) if isinstance(a.default, list)
                 else a.default)
                for a in parser._actions for o in a.option_strings}

    if cmd == "stream":
        def verbs(parser):
            return {name: flags(p) for name, p in subparsers(
                subparsers(parser)["stream"]).items()}

        assert verbs(tcli.build_parser()) == verbs(jcli.build_parser())
        return
    got = flags(subparsers(tcli.build_parser())[cmd])
    want = flags(subparsers(jcli.build_parser())[cmd])
    extra = {("--device", None if cmd == "supervise" else "cuda")}
    if cmd in ("train", "score", "stream-train"):
        extra.add(("--dist-backend", None))
    if cmd == "score":
        extra |= {("--coordinator", None), ("--num-processes", None),
                  ("--process-id", None)}
    assert got - want == extra
    assert want <= got


# ---- exit codes --------------------------------------------------------
def test_score_without_model_exits_2(tmp_path):
    argv = ["score", "--books", str(tmp_path), "--lang", "FR",
            "--models-dir", str(tmp_path), "--output-dir", str(tmp_path)]
    rc, _, se = run(port_main, argv)
    assert rc == 2 and "no committed model for lang FR" in se
    assert run(jax_main, argv)[0] == 2


def test_resume_mismatch_exits_2(native_lib, corpus, tmp_path):
    books, stop = corpus
    ckpt = str(tmp_path / "ckpt")
    jresume.write_resume_meta(ckpt, JParams(k=9), 12345)
    rc, _, se = run(port_main, [
        "train", "--books", books, "--stop-words", stop, "--k", "2",
        "--max-iterations", "1", "--models-dir", str(tmp_path / "m"),
        "--checkpoint-dir", ckpt, "--resume", "--token-layout", "packed"])
    assert rc == 2 and "cannot resume" in se
    assert not os.path.exists(tmp_path / "m")
    rc, _, se = run(port_main, ["train", "--books", books, "--resume"])
    assert rc == 2 and "--resume requires --checkpoint-dir" in se


_ITEM_10 = "is not ported yet (ROADMAP.md queue 1 item 10"
_SERVE_RESIZE = "a serve fleet resizes from --actions-file only"
_AUTOSCALE = "requires --role serve, --front-port and --actions-file"
REFUSED = [
    (["train", "--compile-cache", "cc"], "--compile-cache", _ITEM_10),
    (["score", "--compile-cache", "cc"], "--compile-cache", _ITEM_10),
    (["stream-score", "--compile-cache", "cc"], "--compile-cache",
     _ITEM_10),
    (["stream-train", "--compile-cache", "cc"], "--compile-cache",
     _ITEM_10),
    (["supervise", "--autoscale"], "--autoscale", _AUTOSCALE),
    (["supervise", "--role", "serve", "--front-port", "0", "--autoscale"],
     "--autoscale", _AUTOSCALE),
    (["supervise", "--role", "serve", "--resize-at", "0:3"], "--resize-at",
     _SERVE_RESIZE),
    (["supervise", "--role", "serve", "--scale-out-depth", "4"],
     "--scale-out-depth", _SERVE_RESIZE),
    (["supervise", "--role", "serve", "--scale-out-sweeps", "2"],
     "--scale-out-sweeps", _SERVE_RESIZE),
    (["supervise", "--role", "serve", "--scale-in-sweeps", "2"],
     "--scale-in-sweeps", _SERVE_RESIZE),
    (["supervise", "--compile-cache", "cc"], "--compile-cache", _ITEM_10),
    (["serve", "--compile-cache", "cc"], "--compile-cache", _ITEM_10),
]


@pytest.mark.parametrize("argv,flag,why", REFUSED,
                         ids=[" ".join(a) for a, _, _ in REFUSED])
def test_unported_flags_exit_2_and_name_their_item(tmp_path, argv, flag,
                                                   why):
    """Each flag whose machinery is not ported exits 2 before any work,
    naming its ROADMAP.md queue 1 item; so does each flag the JAX CLI
    accepts and ignores for the role given (a serve fleet resizes from the
    actions file only, and the autoscaler needs a serve fleet's front and
    an actions file): none is accepted and ignored."""
    if argv[0] == "supervise":
        books = ["--watch-dir", str(tmp_path / "none"), "--fleet-dir",
                 str(tmp_path / "fleet")]
    elif argv[0] == "serve":
        books = ["--models-dir", str(tmp_path / "none")]
    else:
        source = "--watch-dir" if argv[0].startswith("stream") else "--books"
        books = [source, str(tmp_path / "none")]
    rc, so, se = run(port_main, [*argv[:1], *books, *argv[1:]])
    assert rc == 2 and so == ""
    sep = " " if why == _ITEM_10 else ": "
    assert f"error: {flag}{sep}{why}" in se
    assert not os.path.exists(tmp_path / "fleet")


# each serve-fleet flag of ``supervise`` (and of the replica it starts):
# the supervise flags given, the replica's (index, generation, spawn id),
# and the ``serve`` argument of the replica that must hold the value
# (None: the flag stays with the supervisor)
SERVE_FLEET_FLAGS = [
    ("--role serve", [], (0, 0, 0), "fn", tcli.cmd_serve),
    ("--front-port", ["--front-port", "0"], (0, 0, 0), None, None),
    ("--max-seconds", ["--max-seconds", "5"], (0, 0, 0), "max_seconds",
     None),
    ("--swap-timeout", ["--swap-timeout", "9"], (0, 0, 0), None, None),
    ("--serve-max-batch", ["--serve-max-batch", "8"], (0, 0, 0),
     "max_batch", 8),
    ("--serve-linger-ms", ["--serve-linger-ms", "1"], (0, 0, 0),
     "linger_ms", 1.0),
    ("--serve-emulate-doc-ms", ["--serve-emulate-doc-ms", "1"], (0, 0, 0),
     "emulate_doc_ms", 1.0),
    ("--serve-max-queue", ["--serve-max-queue", "4"], (0, 0, 0),
     "max_queue", 4),
    ("--serve-batch-weight", ["--serve-batch-weight", "0.5"], (0, 0, 0),
     "batch_weight", 0.5),
    ("serve --emulate-doc-ms", ["--serve-emulate-doc-ms", "5"], (0, 0, 0),
     "emulate_doc_ms", 5.0),
    ("serve --fleet-dir", [], (0, 0, 0), "fleet_dir", "FLEET"),
    ("serve --worker-index", [], (1, 0, 4), "worker_index", 1),
    ("serve --fleet-generation", [], (0, 2, 0), "fleet_generation", 2),
    ("serve --fleet-spawn-id", [], (0, 0, 3), "fleet_spawn_id", 3),
    ("serve --heartbeat-interval", ["--heartbeat-interval", "0.2"],
     (0, 0, 0), "heartbeat_interval", 0.2),
    ("serve --lease-timeout", ["--lease-timeout", "5"], (0, 0, 0),
     "lease_timeout", 5.0),
]


def _jax_replica_argv(monkeypatch, argv, ids):
    """The replica argv the JAX CLI's ``supervise --role serve`` builds for
    ``ids``, read from its supervisor's constructor (whose run then ends
    the command)."""
    import signal

    from spark_text_clustering_tpu.resilience import ResilienceError
    from spark_text_clustering_tpu.resilience import supervisor as jsup

    got = {}

    class Recorder:
        def __init__(self, fleet_dir, worker_argv, **kw):
            got["argv"] = list(worker_argv(ids[0], 2, ids[1], ids[2]))

        def run(self):
            raise ResilienceError("argv recorded")

    monkeypatch.setattr(jsup, "ServeFleetSupervisor", Recorder)
    before = signal.getsignal(signal.SIGTERM)
    try:
        rc, _, _ = run(jax_main, argv)
    finally:
        signal.signal(signal.SIGTERM, before)
    assert rc == 1
    return got["argv"]


@pytest.mark.parametrize("case", SERVE_FLEET_FLAGS,
                         ids=[c[0] for c in SERVE_FLEET_FLAGS])
def test_serve_fleet_flags_reach_the_replica_argv(tmp_path, monkeypatch,
                                                  case):
    """``supervise --role serve`` builds each replica's argv as the JAX
    CLI does (its module name swapped), and the port's replica, given
    ``--device``, parses it to the ``serve`` arguments and the
    ``ScoringService`` arguments it stands for."""
    from spark_text_clustering_tpu_torch.resilience import (
        CorruptArtifactError,
    )
    from spark_text_clustering_tpu_torch.serving import server as tserver

    _, extra, ids, dest, want = case
    fleet = str(tmp_path / "fleet")
    argv = ["supervise", "--role", "serve", "--fleet-dir", fleet,
            "--models-dir", str(tmp_path / "models"), *extra]
    jargv = _jax_replica_argv(monkeypatch, argv, ids)
    sargs = tcli.build_parser().parse_args(argv)
    targv = tcli._serve_replica_argv(sargs, ids[0], 2, ids[1], ids[2])
    assert jargv[2] == "spark_text_clustering_tpu.cli"
    assert targv == [*jargv[:2], "spark_text_clustering_tpu_torch.cli",
                     *jargv[3:]]
    cargs = tcli.build_parser().parse_args([*argv, "--device", "cpu"])
    rargv = tcli._serve_replica_argv(cargs, ids[0], 2, ids[1], ids[2])
    assert rargv[3] == "serve" and rargv[-2:] == ["--device", "cpu"]
    rargs = tcli.build_parser().parse_args(rargv[3:])
    if dest is not None:
        assert getattr(rargs, dest) == (fleet if want == "FLEET" else want)
    else:
        assert extra[0] not in rargv
    seen = {}

    def service(models_dir, lang, **kw):
        seen.update(kw)
        raise CorruptArtifactError(models_dir, "stub")

    monkeypatch.setattr(tserver, "ScoringService", service)
    assert rargs.fn(rargs) == 2
    assert seen["device"] == torch.device("cpu")
    assert (seen["max_batch"], seen["linger_s"], seen["max_queue"],
            seen["batch_weight"], seen["replica_index"],
            seen["watch_model"]) == (
        rargs.max_batch, rargs.linger_ms / 1000.0, rargs.max_queue,
        rargs.batch_weight, ids[0], False)
    assert seen["emulate_doc_seconds"] == (
        None if rargs.emulate_doc_ms is None
        else rargs.emulate_doc_ms / 1000.0)
    # the replica's lease beat before the model's load
    assert os.path.exists(os.path.join(fleet, "leases",
                                       f"w{ids[0]:03d}.json"))


def test_serve_subprocess_answers_and_drains(trained, corpus, tmp_path):
    """``serve --device cpu --port 0 --max-seconds`` as a subprocess on the
    port's trained model: the URL line once warm, one POST of three books
    whose distributions equal in bytes the port's per-doc scoring of the
    same books here, then SIGTERM and the drain report (no retrace after
    warmup), exit 0; its telemetry stream starts with the serve manifest
    and holds the drain."""
    import signal
    import subprocess
    import sys
    import urllib.request

    books, stop = corpus
    model_dir = trained["port"][3]
    texts = [d.text for d in read_text_dir(books)][:3]
    stream = str(tmp_path / "serve.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "serve", "--model", model_dir, "--stop-words", stop,
         "--device", "cpu", "--port", "0", "--max-seconds", "120",
         "--max-batch", "4", "--linger-ms", "1", "--token-bucket", "1024",
         "--token-bucket", "4096", "--telemetry-file", stream],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert " on http://127.0.0.1:" in line, (line, proc.stderr.read()
                                                 if proc.poll() else "")
        assert "warmed buckets [1024, 4096]" in line
        url = line.split(" on ")[1].split(" ")[0]
        req = urllib.request.Request(
            f"{url}/score", data=json.dumps({"texts": texts}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            doc = json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert ("drain complete: 3 request(s) in" in out
            and "0 refused while draining, 0 recompile(s) after warmup"
            in out), out
    model = tload_model(model_dir, device="cpu")
    pre = tpipeline.TextPreprocessor(stop_words=tcli._load_stop_words(stop))
    rows = tpipeline.make_vectorizer(model.vocab)(
        pre.transform({"texts": texts})["tokens"])
    want = model.topic_distribution(rows, convergence="per_doc")
    got = np.asarray([r["distribution"] for r in doc["results"]],
                     np.float64).astype(np.float32)
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()
    assert doc["model"]["model"] == model_dir
    with open(stream, encoding="utf-8") as f:
        events = [json.loads(x) for x in f]
    assert events[0]["event"] == "manifest" and events[0]["kind"] == "serve"
    drained = [e for e in events if e["event"] == "serve_drained"]
    assert len(drained) == 1 and drained[0]["requests"] == 3


def test_native_front_end_under_concurrent_requests(native_lib, corpus):
    """17 threads running one ``TextPreprocessor`` at once (the serve
    handlers' vectorize) give each book the tokens a lone call gives."""
    import threading

    books, stop = corpus
    texts = [d.text for d in read_text_dir(books)]
    texts = (texts * 2)[:17]
    pre = tpipeline.TextPreprocessor(stop_words=tcli._load_stop_words(stop))
    want = [pre.transform({"texts": [t]})["tokens"][0] for t in texts]
    assert pre.last_backend == "native"
    got = [None] * len(texts)
    start = threading.Barrier(len(texts))

    def client(i):
        start.wait(10.0)
        for _ in range(3):
            got[i] = pre.transform({"texts": [texts[i]]})["tokens"][0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert got == want


GRID_REFUSED = [
    (["train", "--num-processes", "2"],
     "--num-processes/--process-id require --coordinator"),
    (["train", "--process-id", "0"],
     "--num-processes/--process-id require --coordinator"),
    (["score", "--num-processes", "2", "--process-id", "1"],
     "--num-processes/--process-id require --coordinator"),
    (["train", "--coordinator", "localhost:1"],
     "--coordinator requires --num-processes and --process-id"),
    (["train", "--coordinator", "localhost:1", "--num-processes", "3",
      "--process-id", "0", "--data-shards", "2"],
     "--num-processes 3 != --data-shards 2 x --model-shards 1"),
    (["score", "--model-shards", "2", "--per-doc-convergence"],
     "--per-doc-convergence does not support sharded scoring"),
    (["train", "--data-shards", "2", "--model-shards", "2",
      "--dist-backend", "nccl"],
     "backend='nccl' takes one rank a card, and 4 ranks share 0 visible "
     "card(s); use backend='gloo'"),
    (["score", "--data-shards", "2", "--dist-backend", "nccl", "--device",
      "cpu"], "backend='nccl' reduces CUDA tensors only; use backend='gloo'"),
]


@pytest.mark.parametrize("argv,message", GRID_REFUSED,
                         ids=[" ".join(a) for a, _ in GRID_REFUSED])
def test_grid_flags_that_cannot_run_exit_2(tmp_path, argv, message):
    """A grid the port cannot run exits 2 before any work, saying why:
    bring-up flags without --coordinator or short of it, a process count
    that is not the grid's,
    per-doc convergence on a grid, and nccl with more ranks than cards (or
    on the CPU).  The default device is kept, so the nccl case counts this
    host's cards: none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card count differs")
    books = ["--books", str(tmp_path / "none")]
    rc, so, se = run(tcli.main, [*argv[:1], *books, *argv[1:]])
    assert rc == 2 and so == ""
    assert f"error: {message}" in se


def _online_start(books, stop, path, seed=23):
    """One random lambda [K, V] over the CLI's vocabulary, written as a
    step-0 train_state.npz by the JAX package's checkpoint writer."""
    ds = {"texts": [d.text for d in read_text_dir(books)]}
    ds = tpipeline.TextPreprocessor(
        stop_words=tcli._load_stop_words(stop)).transform(ds)
    ds = tpipeline.CountVectorizer().fit(ds).transform(ds)
    lam = np.random.default_rng(seed).gamma(100.0, 0.01,
                                            (K, len(ds["vocab"])))
    j_save_train_state(os.path.join(path, "train_state.npz"), 0,
                       lam=lam.astype(np.float32))


ONLINE_ARGV = {
    "defaults": [],
    "epoch_padded": ["--sampling", "epoch", "--token-layout", "padded"],
}


def jax_gamma_rows(self, run, step, ids):
    """The port's online gamma inits replaced by the JAX package's draws
    for the same (seed, step, doc ids)."""
    key = jax.random.fold_in(jax.random.PRNGKey(self.params.seed), step)
    return torch.from_numpy(np.array(jonline.init_gamma_rows(
        key, jax.numpy.asarray(ids.numpy()), run.k,
        self.params.gamma_shape)))


@pytest.mark.parametrize("case", sorted(ONLINE_ARGV))
def test_train_online_matches_jax_cli(native_lib, corpus, tmp_path, case,
                                      monkeypatch):
    """``train --algorithm online`` (with the defaults: bernoulli
    sampling, "auto", which pads these books; and on the padded layout
    with epoch sampling) exits 0 in both CLIs from one lambda in
    train_state.npz, the port fed the JAX package's gamma inits: stdout
    equal line for line with numbers, times and paths masked (the top
    terms included), lam within rtol 1e-4 after 2 iterations (measured
    2.2e-5; later, a tile that stops one inner iteration apart at the
    tol boundary moves lam by ~3e-4, by 1.6% at 12 iterations, and by
    4e-5 over 50 with estep_tol=1e-6); then the port's ``score`` of its
    model writes a report of distributions summing to 1.  The JAX side
    runs its padded E-step kernel (interpret mode), whose per-tile stop
    and inline digamma the port's E-step has on every device."""
    monkeypatch.setattr(tonline.OnlineLDA, "_gamma_rows", jax_gamma_rows)
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    books, stop = corpus
    base = str(tmp_path / "start")
    _online_start(books, stop, base)
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        ckpt, models = str(tmp_path / f"ck_{name}"), str(tmp_path / f"m_{name}")
        shutil.copytree(base, ckpt)
        with jax_python_text():
            rc, so, se = run(main, [
                "train", "--books", books, "--stop-words", stop,
                "--algorithm", "online", "--k", str(K), "--models-dir",
                models, "--checkpoint-dir", ckpt, "--resume",
                "--max-iterations", "2", "--data-shards", "1",
                *ONLINE_ARGV[case]])
        assert rc == 0, se
        (saved,) = os.listdir(models)
        out[name] = (so, os.path.join(models, saved), ckpt)
    (jout, jdir, jck), (tout, tdir, tck) = out["jax"], out["port"]
    with np.load(os.path.join(jdir, "arrays.npz")) as j, \
            np.load(os.path.join(tdir, "arrays.npz")) as t:
        np.testing.assert_allclose(t["lam"], j["lam"], rtol=1e-4)
    jm = mask(jout, [(jck, "<ckpt>"), (os.path.dirname(jdir), "<models>")])
    tm = mask(tout, [(tck, "<ckpt>"), (os.path.dirname(tdir), "<models>")])
    assert "resuming from checkpoint <ckpt>/train_state.npz" in tm
    assert tm.splitlines() == jm.splitlines()
    rc, _, se = run(port_main, [
        "score", "--books", books, "--stop-words", stop, "--model", tdir,
        "--output-dir", str(tmp_path / "o")])
    assert rc == 0, se
    dist = chip_smoke.report_distributions(report_of(str(tmp_path / "o")), K)
    assert dist.shape == (10, K) and np.allclose(dist.sum(1), 1.0, atol=1e-4)


def test_metrics_file_and_profile_dir(native_lib, corpus, tmp_path):
    """--metrics-file writes the JAX package's record schema (corpus,
    phase, train_iteration, model_saved); --profile-dir writes a Chrome
    trace of training."""
    import json

    books, stop = corpus
    metrics, prof = str(tmp_path / "m.jsonl"), str(tmp_path / "prof")
    rc, _, se = run(port_main, [
        "train", "--books", books, "--stop-words", stop, "--k", "2",
        "--max-iterations", "3", "--models-dir", str(tmp_path / "m"),
        "--token-layout", "packed", "--metrics-file", metrics,
        "--profile-dir", prof])
    assert rc == 0, se
    with open(metrics, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f]
    events = [r["event"] for r in recs]
    assert events[0] == "corpus" and events[-1] == "model_saved"
    assert {r["name"] for r in recs if r["event"] == "phase"} == {
        "read", "preprocess", "train"}
    assert events.count("train_iteration") == 3
    assert all("ts" in r for r in recs)
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace), encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)


# ---- the CLI on a grid ---------------------------------------------------
GRID_FLAGS = ["--data-shards", "2", "--model-shards", "2",
              "--dist-backend", "gloo"]


def _grid_argv(books, stop, models):
    return ["train", "--books", books, "--stop-words", stop, "--k", str(K),
            "--models-dir", models, "--token-layout", "packed",
            "--max-iterations", str(ITERS)]


def _masked(stdout, models):
    return mask(stdout, [(models, "<models>")]).splitlines()


@pytest.fixture(scope="module")
def grid_trained(native_lib, corpus, tmp_path_factory):
    """The port's ``train`` from the default seed on one device and on a
    2x2 grid of gloo CPU ranks it spawns itself (V is odd here, so the
    grid pads N_wk to V + 1 columns): {"1x1"|"2x2": (rc, stdout, stderr,
    models dir)}."""
    books, stop = corpus
    root = tmp_path_factory.mktemp("grid_train")
    out = {}
    for name, extra in (("1x1", []), ("2x2", GRID_FLAGS)):
        models = str(root / f"m_{name}")
        rc, so, se = run(port_main, [*_grid_argv(books, stop, models),
                                     *extra])
        out[name] = (rc, so, se, models)
    return out


def _lam(models):
    (saved,) = os.listdir(models)
    with np.load(os.path.join(models, saved, "arrays.npz")) as z:
        return z["lam"]


def test_train_on_a_grid_matches_one_device(grid_trained):
    """``train --data-shards 2 --model-shards 2 --dist-backend gloo``
    spawns four ranks, which start from the one-device fit's counts;
    rank 0 alone prints and saves: stdout equal to the one-device run's
    line for line with numbers and paths masked, one model saved, lam
    within rtol 1e-4 and the average log-likelihood within 1e-4
    relative."""
    (rc1, out1, err1, m1), (rc4, out4, err4, m4) = (
        grid_trained["1x1"], grid_trained["2x2"])
    assert rc1 == 0 and rc4 == 0, (err1, err4)
    assert _masked(out4, m4) == _masked(out1, m1)
    np.testing.assert_allclose(_lam(m4), _lam(m1), rtol=1e-4, atol=1e-4)
    assert _avg_loglik(out4) == pytest.approx(_avg_loglik(out1), rel=1e-4)


@pytest.mark.parametrize("shards", [["--model-shards", "2"], GRID_FLAGS],
                         ids=["1x2", "2x2"])
def test_score_on_a_grid_matches_one_device(grid_trained, corpus, tmp_path,
                                            shards):
    """``score`` of the grid's model on a grid: the report equal to the
    one-device report with floats masked, the distributions within 1e-4
    (the grid scores padded buckets through the E-step's plain version,
    one device the packed batch)."""
    books, stop = corpus
    (saved,) = os.listdir(grid_trained["2x2"][3])
    model = os.path.join(grid_trained["2x2"][3], saved)
    reports = {}
    for name, extra in (("1x1", []), ("grid", shards)):
        out_dir = str(tmp_path / name)
        rc, so, se = run(port_main, [
            "score", "--books", books, "--stop-words", stop, "--model",
            model, "--output-dir", out_dir, *extra])
        assert rc == 0, se
        reports[name] = (report_of(out_dir), so.replace(out_dir, "<o>"))
    assert mask(reports["grid"][0]) == mask(reports["1x1"][0])
    assert mask(reports["grid"][1]) == mask(reports["1x1"][1])
    np.testing.assert_allclose(
        chip_smoke.report_distributions(reports["grid"][0], K),
        chip_smoke.report_distributions(reports["1x1"][0], K), atol=1e-4)


def test_coordinator_run_of_two_processes(grid_trained, corpus, tmp_path):
    """Two processes started by hand, ``--coordinator localhost:<port>
    --num-processes 2 --process-id i --data-shards 2``, meet at a port
    bound to 0: both exit 0, rank 1 prints nothing, rank 0 prints what
    the one-device run prints and saves the one model, lam within rtol
    1e-4 of it."""
    import socket
    import subprocess
    import sys

    books, stop = corpus
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    models = str(tmp_path / "m")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         *_grid_argv(books, stop, models), "--device", "cpu",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--data-shards", "2"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[1][0] == ""
    _, out1, _, m1 = grid_trained["1x1"]
    assert _masked(outs[0][0], models) == _masked(out1, m1)
    np.testing.assert_allclose(_lam(models), _lam(m1), rtol=1e-4, atol=1e-4)


# ---- online VB and NMF on a grid; NMF scoring (fault N1) -----------------
# --vocab-size keeps V even: the grid draws lambda at V_pad columns, as
# the JAX package does, so an odd V starts from another draw than 1x1
ALGO_ARGV = {
    "online": ["--algorithm", "online", "--sampling", "fixed",
               "--token-layout", "padded", "--vocab-size", "3000"],
    "nmf": ["--algorithm", "nmf"],
}


@pytest.fixture(scope="module")
def algo_trained(native_lib, corpus, tmp_path_factory):
    """The port's ``train --algorithm online|nmf`` from the default seed
    on one device and on a 2x2 grid of gloo CPU ranks:
    {(algorithm, "1x1"|"2x2"): (rc, stdout, stderr, models dir)}."""
    books, stop = corpus
    root = tmp_path_factory.mktemp("algo_train")
    out = {}
    for algo, argv in ALGO_ARGV.items():
        for name, extra in (("1x1", []), ("2x2", GRID_FLAGS)):
            models = str(root / f"m_{algo}_{name}")
            rc, so, se = run(port_main, [
                "train", "--books", books, "--stop-words", stop, "--k",
                str(K), "--models-dir", models, "--max-iterations",
                str(ITERS), *argv, *extra])
            out[algo, name] = (rc, so, se, models)
    return out


@pytest.mark.parametrize("algo,array", [("online", "lam"), ("nmf", "h")])
def test_train_online_and_nmf_on_a_grid_match_one_device(algo_trained, algo,
                                                         array):
    """``train --algorithm online`` (fixed sampling, the padded layout)
    and ``--algorithm nmf`` with ``--data-shards 2 --model-shards 2
    --dist-backend gloo`` start from the one-device fit's draws: rank 0
    alone prints and saves, stdout equal to the one-device run's line for
    line with numbers and paths masked, lambda or H within rtol 1e-4."""
    (rc1, out1, err1, m1), (rc4, out4, err4, m4) = (
        algo_trained[algo, "1x1"], algo_trained[algo, "2x2"])
    assert rc1 == 0 and rc4 == 0, (err1, err4)
    assert _masked(out4, m4) == _masked(out1, m1)
    arrays = []
    for models in (m1, m4):
        (saved,) = os.listdir(models)
        with np.load(os.path.join(models, saved, "arrays.npz")) as z:
            arrays.append(z[array])
    np.testing.assert_allclose(arrays[1], arrays[0], rtol=1e-4, atol=1e-7)


def test_score_nmf_model_matches_jax_cli(algo_trained, corpus, tmp_path):
    """Fault N1: the port's ``score`` of a saved NMF model exits 0 (it
    raised ``TypeError`` on the ``grid`` argument) as the JAX package's
    ``score`` of the same model does; the reports are equal with floats
    masked and the distributions agree within atol 1e-4."""
    books, stop = corpus
    (saved,) = os.listdir(algo_trained["nmf", "1x1"][3])
    model = os.path.join(algo_trained["nmf", "1x1"][3], saved)
    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_dir = str(tmp_path / name)
        with jax_python_text():
            rc, so, se = run(main, ["score", "--books", books, "--stop-words",
                                    stop, "--model", model, "--output-dir",
                                    out_dir])
        assert rc == 0, se
        reports[name] = (report_of(out_dir), so.replace(out_dir, "<o>"))
    assert mask(reports["port"][0]) == mask(reports["jax"][0])
    assert mask(reports["port"][1]) == mask(reports["jax"][1])
    np.testing.assert_allclose(
        chip_smoke.report_distributions(reports["port"][0], K),
        chip_smoke.report_distributions(reports["jax"][0], K), atol=1e-4)


def test_score_grid_trained_nmf_model(algo_trained, corpus, tmp_path):
    """``score`` of the 2x2 grid's NMF model, on one device and on a 2x2
    grid (the W solve runs on each rank's device, rank 0 reports): both
    exit 0 with reports equal, floats masked, to the one-device model's
    report, and distributions within atol 1e-4 of it."""
    books, stop = corpus
    reports = {}
    for name, trained, extra in (("1x1", "1x1", []), ("model_2x2", "2x2", []),
                                 ("grid", "2x2", GRID_FLAGS)):
        models = algo_trained["nmf", trained][3]
        (saved,) = os.listdir(models)
        out_dir = str(tmp_path / name)
        rc, so, se = run(port_main, [
            "score", "--books", books, "--stop-words", stop, "--model",
            os.path.join(models, saved), "--output-dir", out_dir, *extra])
        assert rc == 0, se
        reports[name] = report_of(out_dir)
    want = chip_smoke.report_distributions(reports["1x1"], K)
    for name in ("model_2x2", "grid"):
        assert mask(reports[name]) == mask(reports["1x1"])
        np.testing.assert_allclose(
            chip_smoke.report_distributions(reports[name], K), want,
            atol=1e-4)


# ---- the stream verbs ------------------------------------------------------
STREAM_FLAGS = ["--poll-interval", "0.01", "--idle-timeout", "0.2"]


@pytest.fixture()
def sigterm_restored():
    """The JAX CLI's stream verbs install a SIGTERM drain handler for good
    (a stream is its process): put the test process's back."""
    import signal

    old = signal.getsignal(signal.SIGTERM)
    yield old
    signal.signal(signal.SIGTERM, old)


@pytest.fixture(scope="module")
def stream_books(tmp_path_factory):
    """Six small books of chip_smoke's recipe, their mtimes one second
    apart in name order, and a stop-word file."""
    root = tmp_path_factory.mktemp("stream_books")
    stop = chip_smoke.en_books_dir(7, str(root), n_books=6,
                                   words=(300, 1500))
    books = str(root / "books")
    for i, name in enumerate(sorted(os.listdir(books))):
        os.utime(os.path.join(books, name), (1e9 + i, 1e9 + i))
    return books, stop


def jax_stream_draws(monkeypatch, k=K, hash_features=1024, seed=0):
    """The port's stream trainer fed the JAX package's lambda0 and gamma
    inits for the same seed."""
    from spark_text_clustering_tpu.ops.lda_math import (
        init_gamma as j_init_gamma, init_lambda as j_init_lambda,
    )
    key = jax.random.PRNGKey(seed)
    lam0 = np.asarray(j_init_lambda(jax.random.fold_in(key, 0xFFFF), k,
                                    hash_features, 100.0))

    def gamma0(step, n):
        return np.asarray(j_init_gamma(jax.random.fold_in(key, step), n, k,
                                       100.0))

    trainer = tcli.StreamingOnlineLDA

    def with_jax_draws(params, **kw):
        return trainer(params, init_lam=lam0, gamma0_fn=gamma0, **kw)

    monkeypatch.setattr(tcli, "StreamingOnlineLDA", with_jax_draws)


def _stream_train(main, books, stop, root, *extra):
    models = os.path.join(root, "m")
    rc, so, se = run(main, [
        "stream-train", "--watch-dir", books, "--stop-words", stop,
        "--k", str(K), "--hash-features", "1024", "--checkpoint-dir",
        os.path.join(root, "ck"), "--checkpoint-interval", "2",
        "--max-files-per-trigger", "2", "--models-dir", models,
        *STREAM_FLAGS, *extra])
    saved = sorted(os.listdir(models)) if os.path.isdir(models) else []
    return rc, so, se, os.path.join(models, saved[-1]) if saved else None


def _ledger_records(ck):
    """A ledger's records with the timestamps, checksums and digests
    dropped."""
    with open(os.path.join(ck, "epochs.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for rec in recs:
        rec.pop("ts"), rec.pop("checksum")
        for s in rec.get("shards", ()):
            s.pop("sha256")
        for s in rec["payloads"].values():
            s.pop("sha256")           # the reports' floats are masked
        if isinstance(rec.get("model_ref"), dict):
            # a published model: its dir and manifest digest are the run's
            rec["model_ref"] = sorted(rec["model_ref"])
    return recs


@pytest.fixture(scope="module")
def streamed(native_lib, stream_books, tmp_path_factory):
    """Both CLIs' ``stream-train`` over the six books (three triggers of
    two, a checkpoint after the second and one at the end), the port fed
    the JAX package's draws, then both CLIs' ``stream-score`` of the JAX
    model with a ledger, and a second ``stream-score`` run over the same
    dir: {package: (train (rc, stdout, stderr, model dir), score runs,
    root)}."""
    import signal

    books, stop = stream_books
    handler = signal.getsignal(signal.SIGTERM)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_stream_draws(mp)
        mp.setenv("STC_GAMMA_BACKEND", "pallas")
        for name, main in (("jax", jax_main), ("port", port_main)):
            root = str(tmp_path_factory.mktemp(f"stream_{name}"))
            with jax_python_text():
                train = _stream_train(main, books, stop, root)
            out[name] = (train, root)
        model = out["jax"][0][3]
        for name, main in (("jax", jax_main), ("port", port_main)):
            root = out[name][1]
            scores = []
            for _ in range(2):
                with jax_python_text():
                    scores.append(run(main, [
                        "stream-score", "--watch-dir", books, "--stop-words",
                        stop, "--model", model, "--checkpoint-dir",
                        os.path.join(root, "sck"), "--output-dir",
                        os.path.join(root, "o"), "--max-files-per-trigger",
                        "4", *STREAM_FLAGS]))
            out[name] = (*out[name], scores)
        signal.signal(signal.SIGTERM, handler)
    return out


def test_stream_train_matches_jax_cli(streamed):
    """``stream-train`` exits 0 in both CLIs with stdout equal line for
    line (the top terms included; paths masked), lambda within rtol 1e-4
    of the JAX package's (the online tolerance), the same ledger records
    (timestamps and digests masked) and a meta.json ledger_ref of the
    same epoch."""
    (jtrain, jroot, _), (ttrain, troot, _) = streamed["jax"], streamed["port"]
    assert jtrain[0] == ttrain[0] == 0, (jtrain[2], ttrain[2])
    with np.load(os.path.join(jtrain[3], "arrays.npz")) as j, \
            np.load(os.path.join(ttrain[3], "arrays.npz")) as t:
        np.testing.assert_allclose(t["lam"], j["lam"], rtol=1e-4)
    assert mask(ttrain[1], [(troot, "<r>")]) == mask(jtrain[1],
                                                     [(jroot, "<r>")])
    assert "stream ended: 6 docs / 3 micro-batches" in ttrain[1]
    jrecs = _ledger_records(os.path.join(jroot, "ck"))
    trecs = _ledger_records(os.path.join(troot, "ck"))
    assert [r["kind"] for r in trecs] == ["stream-train"] * 2 + [
        "model-publish"]
    assert trecs == jrecs
    for path, root in ((jtrain[3], jroot), (ttrain[3], troot)):
        with open(os.path.join(path, "meta.json")) as f:
            assert json.load(f)["ledger_ref"] == {
                "dir": os.path.join(root, "ck"), "epoch": 2}


def test_stream_score_matches_jax_cli(streamed, sigterm_restored):
    """``stream-score`` of one model with a ledger: exit codes and stdout
    equal (paths and floats masked), each epoch's report equal with floats
    masked and its distributions within atol 1e-4 of the JAX package's;
    a second run over the same dir commits nothing and scores nothing in
    either; the port's verb puts the SIGTERM handler back."""
    import signal

    (_, jroot, jscores), (_, troot, tscores) = (streamed["jax"],
                                                streamed["port"])
    model = (os.path.join(jroot, "m"), "<m>")
    for (jrc, jout, jerr), (trc, tout, terr) in zip(jscores, tscores):
        assert jrc == trc == 0, (jerr, terr)
        assert mask(tout, [model, (troot, "<r>")]) == mask(
            jout, [model, (jroot, "<r>")])
    assert "[epoch 1] report committed" in tscores[0][1]
    assert "report committed" not in tscores[1][1]
    reports = sorted(os.listdir(os.path.join(troot, "o")))
    assert reports == sorted(os.listdir(os.path.join(jroot, "o"))) == [
        "Result_EN_epoch-000000", "Result_EN_epoch-000001"]
    for name in reports:
        with open(os.path.join(jroot, "o", name)) as f1, \
                open(os.path.join(troot, "o", name)) as f2:
            jrep, trep = f1.read(), f2.read()
        assert mask(trep) == mask(jrep)
        np.testing.assert_allclose(chip_smoke.report_distributions(trep, K),
                                   chip_smoke.report_distributions(jrep, K),
                                   atol=1e-4)
    assert mask(json.dumps(_ledger_records(os.path.join(troot, "sck"))),
                [model, (troot, "<r>")]) == mask(
        json.dumps(_ledger_records(os.path.join(jroot, "sck"))),
        [model, (jroot, "<r>")])
    assert signal.getsignal(signal.SIGTERM) is sigterm_restored
    rc, _, _ = run(port_main, ["stream-score", "--watch-dir", jroot,
                               "--model", os.path.join(jroot, "none")])
    assert rc == 2
    assert signal.getsignal(signal.SIGTERM) is sigterm_restored


def test_stream_compact_and_requeue_match_jax_cli(streamed, tmp_path):
    """``stream compact`` of each package's scoring ledger, and ``stream
    requeue`` (a dry run, then for real) of one quarantine dir copied for
    each: exit codes and stdout equal with paths masked, the compacted
    ledgers equal; each package reads the other's snapshot."""
    from spark_text_clustering_tpu.resilience import EpochLedger as JLedger
    from spark_text_clustering_tpu_torch.resilience import (
        EpochLedger, Quarantine,
    )

    outs = {}
    # the maintenance verbs run on no device: no --device flag
    for name, main in (("jax", jax_main), ("port", tcli.main)):
        root = streamed[name][1]
        ck = str(tmp_path / name / "sck")
        shutil.copytree(os.path.join(root, "sck"), ck)
        q = Quarantine(str(tmp_path / name / "q"))
        for i in range(3):
            q.put(f"/in/doc {i}.txt", f"text {i}", ValueError("bad"),
                  stage="vectorize", batch_id=i)
        runs = [run(main, ["stream", "compact", "--checkpoint-dir", ck]),
                run(main, ["stream", "compact", "--checkpoint-dir", ck]),
                run(main, ["stream", "requeue", "--quarantine-dir",
                           q.directory, "--watch-dir",
                           str(tmp_path / name / "w"), "--dry-run"]),
                run(main, ["stream", "requeue", "--quarantine-dir",
                           q.directory, "--watch-dir",
                           str(tmp_path / name / "w")])]
        outs[name] = [(rc, mask(so, [(str(tmp_path / name), "<t>"),
                                     (root, "<r>")]), se)
                      for rc, so, se in runs]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][1].startswith("compacted 2 committed records")
    assert outs["port"][3][1].endswith("3 replayed, 3 archived, 0 skipped\n")
    (jsnap,) = JLedger(str(tmp_path / "port" / "sck")).records()
    (tsnap,) = EpochLedger(str(tmp_path / "jax" / "sck")).records()
    assert jsnap["kind"] == tsnap["kind"] == "snapshot"


@pytest.mark.parametrize("first", ["jax", "port"])
def test_stream_train_resume_across_packages(native_lib, stream_books,
                                             tmp_path, monkeypatch, first,
                                             sigterm_restored):
    """Four books arrive, one CLI's ``stream-train`` trains them (two
    micro-batches, a checkpoint) and the stream ends idle; two more
    arrive and the other CLI's ``stream-train --resume`` continues from
    the ledger: it announces the committed epoch, never reads the first
    four again, and ends with lambda within rtol 1e-4 of the JAX
    package's uninterrupted run over the six, with the same counters."""
    jax_stream_draws(monkeypatch)
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    books, stop = stream_books
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    names = sorted(os.listdir(books))
    mains = {"jax": jax_main, "port": port_main}
    second = "port" if first == "jax" else "jax"

    def arrive(batch):
        for n in batch:
            shutil.copy2(os.path.join(books, n), os.path.join(watch, n))

    with jax_python_text():
        whole = _stream_train(jax_main, books, stop, str(tmp_path / "whole"))
        arrive(names[:4])
        part = _stream_train(mains[first], watch, stop, str(tmp_path / "r"))
        arrive(names[4:])
        resumed = _stream_train(mains[second], watch, stop,
                                str(tmp_path / "r"), "--resume")
    for rc, so, se, _ in (whole, part, resumed):
        assert rc == 0, se
    assert "stream ended: 4 docs / 2 micro-batches" in part[1]
    assert "(epoch ledger, committed epoch 1)" in resumed[1]
    assert "stream ended: 6 docs / 3 micro-batches" in resumed[1]
    with np.load(os.path.join(whole[3], "arrays.npz")) as w, \
            np.load(os.path.join(resumed[3], "arrays.npz")) as r:
        np.testing.assert_allclose(r["lam"], w["lam"], rtol=1e-4)
    recs = _ledger_records(str(tmp_path / "r" / "ck"))
    train = [r for r in recs if r["kind"] == "stream-train"]
    assert sorted(s for r in train for s in r["sources"]) == [
        os.path.join(watch, n) for n in names]
    assert train[-1]["step"] == 3 and train[-1]["docs_seen"] == 6


def test_fenced_ledger_write_exits_3_in_both(native_lib, stream_books,
                                             tmp_path, monkeypatch,
                                             sigterm_restored):
    """A ledger append refused with FencedEpochError (a superseded fleet
    token) ends both CLIs' stream-train with exit code 3 and the error on
    stderr, the epoch left uncommitted."""
    from spark_text_clustering_tpu.resilience import (
        FencedEpochError as JFenced, ledger as jledger,
    )
    from spark_text_clustering_tpu_torch.resilience import (
        FencedEpochError, ledger as tledger,
    )

    for mod, err in ((jledger, JFenced), (tledger, FencedEpochError)):
        def fenced(self, *a, err=err, **k):
            raise err("/fleet", "generation 1 superseded by 2")

        monkeypatch.setattr(mod.EpochLedger, "commit", fenced)
    books, stop = stream_books
    for name, main in (("jax", jax_main), ("port", port_main)):
        with jax_python_text():
            rc, so, se, model = _stream_train(main, books, stop,
                                              str(tmp_path / name))
        assert rc == 3 and model is None
        assert "error: fenced ledger write (fleet '/fleet')" in se
        assert not os.path.exists(tmp_path / name / "ck" / "epochs.jsonl")


@pytest.mark.parametrize("spawn_id", [0, 1])
def test_stream_worker_flags_match_jax_cli(native_lib, stream_books,
                                           tmp_path, spawn_id,
                                           sigterm_restored):
    """``stream-score`` as worker 1 of 2 of a supervised fleet (the flags
    ``supervise`` passes), in both CLIs, each under a fleet dir whose
    spawn record its own package wrote: with the current token both
    score only the worker's partition of the books, commit the same
    sources in records that carry the worker's identity, and leave a done
    lease (reason idle); with a superseded token (the record names spawn
    id 1) both exit 3 before committing and mark the lease fenced."""
    from spark_text_clustering_tpu.resilience import (
        configure_lease_deadline as j_deadline,
    )
    from spark_text_clustering_tpu.resilience import supervisor as jsup
    from spark_text_clustering_tpu_torch.resilience import supervisor as tsup

    books, stop = stream_books
    model = str(tmp_path / "LdaModel_EN_1000")
    lda_model_from_numpy(
        np.random.default_rng(3).gamma(1.0, 1.0, (K, 1024)),
        np.full(K, 0.5, np.float32), 0.1, [f"h{i}" for i in range(1024)],
        algorithm="online", device="cpu").save(model)
    mine = sorted(os.path.join(books, n) for n in os.listdir(books)
                  if tsup.partition_of(n, 2) == 1)
    assert 0 < len(mine) < 6
    got = {}
    for name, main, sup in (("jax", jax_main, jsup), ("port", port_main,
                                                      tsup)):
        fleet = str(tmp_path / name / "fleet")
        sup.FleetLedger(fleet).append(kind="spawn", generation=0,
                                      worker_count=2, spawn_ids={0: 0, 1: 1})
        ck = sup.worker_dir(fleet, 1)
        try:
            with jax_python_text():
                rc, so, se = run(main, [
                    "stream-score", "--watch-dir", books, "--stop-words",
                    stop, "--model", model, "--checkpoint-dir", ck,
                    "--output-dir", str(tmp_path / name / "o"),
                    "--fleet-dir", fleet, "--worker-index", "1",
                    "--worker-count", "2", "--fleet-spawn-id",
                    str(spawn_id), "--heartbeat-interval", "0.1",
                    "--lease-timeout", "5", *STREAM_FLAGS])
        finally:
            j_deadline(None)
        got[name] = (rc, se, ck, sup.read_lease(sup.lease_path(fleet, 1)))
    for name, (rc, se, ck, lease) in got.items():
        assert lease["worker"] == 1 and lease["spawn_id"] == spawn_id
        assert lease["done"] is True
        if spawn_id == 1:
            assert rc == 0, se
            assert lease["reason"] == "idle"
            recs = tsup.EpochLedger(ck).records()
            assert sorted(s for r in recs for s in r["sources"]) == mine
            assert {(r["worker"], r["generation"], r["spawn_id"])
                    for r in recs} == {(1, 0, 1)}
        else:
            assert rc == 3 and "superseded" in se, se
            assert lease["reason"] == "fenced"
            assert tsup.EpochLedger(ck).records() == []
