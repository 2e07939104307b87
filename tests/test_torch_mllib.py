"""MLlib ``DistributedLDAModel`` artifacts both ways between the port and
the JAX package, on the CPU.

Both sides are built from one seeded numpy model and doc graph (one empty
document included): the JAX package's ``save_reference_model`` and
``load_reference_model`` against the port's, the model selection of
``score``, and both CLIs' ``train --export-mllib`` and ``score --model
<MLlib dir>``.  The CLIs' text front end runs its Python path (nltk) in
both packages, so no native build is needed here.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest

pq = pytest.importorskip("pyarrow.parquet")

import chip_smoke  # noqa: E402
from spark_text_clustering_tpu.models import persistence as jpersistence  # noqa: E402
from spark_text_clustering_tpu.models import reference_import as jimport  # noqa: E402
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel  # noqa: E402
from spark_text_clustering_tpu.models.reference_export import (  # noqa: E402
    save_reference_model as j_save_reference_model,
)
from spark_text_clustering_tpu_torch import pipeline as tpipeline  # noqa: E402
from spark_text_clustering_tpu_torch.models import em_lda as tem  # noqa: E402
from spark_text_clustering_tpu_torch.models import persistence as tpersistence  # noqa: E402
from spark_text_clustering_tpu_torch.models import reference_import as timport  # noqa: E402
from spark_text_clustering_tpu_torch.models.base import LDAModel  # noqa: E402
from spark_text_clustering_tpu_torch.models.reference_export import (  # noqa: E402
    save_reference_model,
)
from spark_text_clustering_tpu_torch.resilience import artifact_status  # noqa: E402
from test_torch_cli import (  # noqa: E402
    _start_state,
    jax_main,
    jax_python_text,
    mask,
    port_main,
    report_of,
    run,
)

K, V, N_DOCS = 4, 37, 9
DATASETS = ("globalTopicTotals", "topicCounts", "tokenCounts")


def _source(alpha: str, seed: int = 5):
    """One model's arrays and doc graph: lam [k, V] f32, alpha [k], rows of
    the corpus (doc 3 empty) and N_dk [n, k] f32."""
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 3.0, size=(K, V)).astype(np.float32)
    lam[1, 7] = 0.0
    a = (np.full(K, 13.5, np.float32) if alpha == "scalar"
         else rng.uniform(1.5, 20.0, K).astype(np.float32))
    rows = []
    for d in range(N_DOCS):
        nnz = 0 if d == 3 else int(rng.integers(2, 12))
        ids = np.sort(rng.choice(V, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.uniform(1e-4, 9.0, nnz).astype(np.float32)))
    n_dk = rng.gamma(1.0, 2.0, size=(N_DOCS, K)).astype(np.float32)
    n_dk[3] = 0.0
    return dict(lam=lam, alpha=a, eta=1.1, gamma_shape=100.0,
                iteration_times=[0.5, 0.25, 0.125], vocab=[
                    f"stem{i}" for i in range(V)], rows=rows, n_dk=n_dk)


def _models(src):
    common = dict(lam=src["lam"], vocab=list(src["vocab"]),
                  alpha=src["alpha"], eta=src["eta"],
                  gamma_shape=src["gamma_shape"],
                  iteration_times=list(src["iteration_times"]),
                  algorithm="em", step=3)
    return JLDAModel(**common), LDAModel(device="cpu", **common)


def _export(save, model, path, src):
    """The CLI's export: doc vertices for all n docs, edges of the
    nonempty ones."""
    save(model, path, doc_topic_counts=src["n_dk"],
         doc_rows=[(i, w) for i, w in src["rows"] if len(i) > 0])


def _scalar_alpha(path):
    """Rewrite the metadata line with docConcentration as one number, as
    MLlib writes a symmetric prior."""
    meta_path = os.path.join(path, "metadata", "part-00000")
    with open(meta_path, encoding="utf-8") as f:
        meta = json.loads(f.readline())
    meta["docConcentration"] = meta["docConcentration"][0]
    with open(meta_path, "w", encoding="utf-8") as f:
        f.write(json.dumps(meta, separators=(",", ":")) + "\n")


@pytest.fixture(params=["vector", "scalar"])
def exported(request, tmp_path):
    """{"jax"|"port": MLlib dir} of one source model, and the source; the
    "scalar" case stores docConcentration as one number (its alpha is
    symmetric, so the loaded [k] vector still equals the source's)."""
    src = _source(request.param)
    jmodel, tmodel = _models(src)
    out = {}
    for name, save, model in (("jax", j_save_reference_model, jmodel),
                              ("port", save_reference_model, tmodel)):
        path = str(tmp_path / name / "LdaModel_EN_1591049082850")
        _export(save, model, path, src)
        if request.param == "scalar":
            _scalar_alpha(path)
        out[name] = path
    return out, src


def _edge_arrays(art):
    """(doc, term, weight) arrays of either reader's edges: the port's
    are arrays already, the JAX reader's a list of tuples."""
    if isinstance(art, timport.MLlibLDAArtifacts):
        return art.edges
    doc, term, w = zip(*art.edges) if art.edges else ((), (), ())
    return (np.asarray(doc, np.int64), np.asarray(term, np.int64),
            np.asarray(w, np.float64))


def _assert_model(got, src, alpha):
    np.testing.assert_array_equal(np.asarray(got.lam), src["lam"])
    np.testing.assert_array_equal(np.asarray(got.alpha), alpha)
    assert got.eta == src["eta"] and got.gamma_shape == src["gamma_shape"]
    assert got.iteration_times == src["iteration_times"]
    assert got.step == len(src["iteration_times"])
    assert got.vocab == src["vocab"] and got.algorithm == "em"


def test_jax_export_loads_in_the_port(exported):
    """(a) A JAX export loads through the port's ``load_reference_model``
    and ``load_model`` with lam (bitwise), alpha, eta, gamma_shape,
    iteration_times, step and vocab equal to the JAX reader's."""
    dirs, src = exported
    _assert_model(jimport.load_reference_model(dirs["jax"]), src,
                  src["alpha"])
    for got in (timport.load_reference_model(dirs["jax"], device="cpu"),
                tpersistence.load_model(dirs["jax"], device="cpu")):
        assert isinstance(got, LDAModel) and got.device == "cpu"
        _assert_model(got, src, src["alpha"])


def test_port_export_loads_in_jax(exported):
    """(b) A port export loads through the JAX package's readers with the
    same fields, and its decoded graph (doc vertices, edges, the rows
    rebuilt from the edges) equals the JAX reader's of the JAX export and
    the port reader's of either."""
    dirs, src = exported
    for got in (jimport.load_reference_model(dirs["port"]),
                jpersistence.load_model(dirs["port"])):
        _assert_model(got, src, src["alpha"])
    arts = [jimport.MLlibLDAArtifacts(dirs["port"]),
            jimport.MLlibLDAArtifacts(dirs["jax"]),
            timport.MLlibLDAArtifacts(dirs["port"]),
            timport.MLlibLDAArtifacts(dirs["jax"])]
    ref = arts[0]
    assert sorted(ref.doc_gammas) == list(range(N_DOCS))
    np.testing.assert_array_equal(ref.doc_gammas[3], np.zeros(K))
    nonempty = [(i, w) for i, w in src["rows"] if len(i) > 0]
    rebuilt = jimport.reference_doc_rows(ref)
    assert [d for d, _, _ in rebuilt] == list(range(len(nonempty)))
    for (_, ids, wts), (i, w) in zip(rebuilt, nonempty):
        np.testing.assert_array_equal(ids, i)
        np.testing.assert_array_equal(wts, w)
    for art in arts[1:]:
        assert art.metadata == ref.metadata
        assert (art.k, art.vocab_size) == (ref.k, ref.vocab_size)
        np.testing.assert_array_equal(art.global_topic_totals,
                                      ref.global_topic_totals)
        np.testing.assert_array_equal(art.beta, ref.beta)
        assert sorted(art.doc_gammas) == sorted(ref.doc_gammas)
        for d, g in ref.doc_gammas.items():
            np.testing.assert_array_equal(art.doc_gammas[d], g)
        for got_a, want_a in zip(_edge_arrays(art), _edge_arrays(ref)):
            assert got_a.dtype == want_a.dtype
            np.testing.assert_array_equal(got_a, want_a)
        reader = timport if isinstance(art, timport.MLlibLDAArtifacts) \
            else jimport
        got = reader.reference_doc_rows(art)
        assert [d for d, _, _ in got] == [d for d, _, _ in rebuilt]
        for (_, i1, w1), (_, i2, w2) in zip(got, rebuilt):
            assert i1.dtype == i2.dtype and w1.dtype == w2.dtype
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(w1, w2)


def test_exporters_write_equal_artifacts(exported):
    """(c) The two exporters write the same files: equal Arrow tables (and
    schema metadata) in every dataset under the same part names, and
    byte-equal metadata/part-00000, _SUCCESS markers and sidecar."""
    dirs, _ = exported

    def listing(path):
        return sorted(os.path.relpath(os.path.join(r, f), path)
                      for r, _, fs in os.walk(path) for f in fs)

    jroot, troot = (os.path.dirname(dirs[n]) for n in ("jax", "port"))
    assert listing(troot) == listing(jroot)
    for ds in DATASETS:
        rel = os.path.join("data", ds)
        (part,) = [f for f in os.listdir(os.path.join(dirs["jax"], rel))
                   if f.endswith(".parquet")]
        jt = pq.read_table(os.path.join(dirs["jax"], rel, part))
        tt = pq.read_table(os.path.join(dirs["port"], rel, part))
        assert tt.schema.equals(jt.schema, check_metadata=True)
        assert tt.equals(jt)
    names = [os.path.join("metadata", "part-00000"),
             os.path.join("metadata", "_SUCCESS"),
             os.path.join("..", "vocabularies", "LdaModel_EN_1591049082850")]
    names += [os.path.join("data", ds, "_SUCCESS") for ds in DATASETS]
    for rel in names:
        with open(os.path.join(dirs["jax"], rel), "rb") as f1, \
                open(os.path.join(dirs["port"], rel), "rb") as f2:
            assert f2.read() == f1.read(), rel
    with open(os.path.join(dirs["port"], "metadata", "part-00000"),
              encoding="utf-8") as f:
        keys = list(json.loads(f.readline()))
    assert keys == ["class", "version", "k", "vocabSize", "docConcentration",
                    "topicConcentration", "iterationTimes", "gammaShape"]


def test_exporters_agree_without_doc_graph(tmp_path):
    """Without doc topic counts and rows both exporters write term vertices
    only and no edge, in equal tables, which both readers load alike."""
    src = _source("vector")
    dirs = {}
    for name, save, model in zip(("jax", "port"),
                                 (j_save_reference_model,
                                  save_reference_model), _models(src)):
        dirs[name] = str(tmp_path / name / "LdaModel_EN_3")
        save(model, dirs[name])
    for ds in DATASETS:
        ds_dir = os.path.join(dirs["jax"], "data", ds)
        (part,) = [f for f in os.listdir(ds_dir) if f.endswith(".parquet")]
        assert pq.read_table(os.path.join(dirs["port"], "data", ds,
                                          part)).equals(
            pq.read_table(os.path.join(ds_dir, part)))
    art = timport.MLlibLDAArtifacts(dirs["port"])
    assert art.doc_gammas == {}
    assert [len(a) for a in art.edges] == [0, 0, 0]
    assert timport.reference_doc_rows(art) == []
    np.testing.assert_array_equal(art.beta,
                                  jimport.MLlibLDAArtifacts(dirs["jax"]).beta)


def test_sparse_vectors_decode_as_jax(tmp_path):
    """VectorUDT rows stored sparse (type 0: size, indices, values), beside
    dense ones, decode to the JAX reader's arrays in the port's reader."""
    import pyarrow as pa

    src = _source("vector")
    _, tmodel = _models(src)
    path = str(tmp_path / "LdaModel_EN_5")
    _export(save_reference_model, tmodel, path, src)
    ds_dir = os.path.join(path, "data", "topicCounts")
    (part,) = [f for f in os.listdir(ds_dir) if f.endswith(".parquet")]
    table = pq.read_table(os.path.join(ds_dir, part))
    vecs = table.column("topicWeights").to_pylist()
    for r, vec in enumerate(vecs):
        if r % 3 == 0:
            vals = np.asarray(vec["values"])
            nz = np.flatnonzero(vals)[::-1]
            vecs[r] = {"type": 0, "size": K, "indices": nz.tolist(),
                       "values": vals[nz].tolist()}
    col = pa.array(vecs, type=table.schema.field("topicWeights").type)
    table = table.set_column(1, "topicWeights", col)
    pq.write_table(table, os.path.join(ds_dir, part))
    want = jimport.MLlibLDAArtifacts(path)
    got = timport.MLlibLDAArtifacts(path)
    np.testing.assert_array_equal(got.beta, want.beta)
    np.testing.assert_array_equal(got.beta.astype(np.float32), src["lam"])
    assert sorted(got.doc_gammas) == sorted(want.doc_gammas)
    for d, g in want.doc_gammas.items():
        np.testing.assert_array_equal(got.doc_gammas[d], g)


def test_model_selection_takes_a_frozen_mllib_dir(tmp_path):
    """(d) An MLlib dir is "legacy" to ``artifact_status`` (as in JAX) and
    ``resolve_latest_model`` picks it where its timestamp is the newest;
    a ``..._mllib`` export is no timestamp and never selected."""
    src = _source("vector")
    jmodel, tmodel = _models(src)
    models = str(tmp_path / "models")
    tmodel.save(os.path.join(models, "LdaModel_EN_100"))
    frozen = os.path.join(models, "LdaModel_EN_200")
    _export(save_reference_model, tmodel, frozen, src)
    _export(save_reference_model, tmodel,
            os.path.join(models, "LdaModel_EN_300_mllib"), src)
    from spark_text_clustering_tpu.resilience import (
        artifact_status as j_artifact_status,
    )

    assert artifact_status(frozen) == j_artifact_status(frozen) == "legacy"
    for deep in (False, True):
        path, model = tpersistence.resolve_latest_model(
            models, "EN", verify_deep=deep, device="cpu")
        assert path == frozen
        assert jpersistence.latest_model_dir(models, "EN", deep) == frozen
        _assert_model(model, src, src["alpha"])
    shutil.rmtree(frozen)
    path, model = tpersistence.resolve_latest_model(models, "EN",
                                                    device="cpu")
    assert path == os.path.join(models, "LdaModel_EN_100")
    assert jpersistence.latest_model_dir(models, "EN") == path
    assert os.path.isdir(os.path.join(models, "LdaModel_EN_300_mllib"))


def test_missing_sidecar_raises_jax_message(tmp_path):
    """(e) Without its vocabulary sidecar an MLlib dir does not load for
    scoring: FileNotFoundError with the JAX package's message; the
    placeholder vocabulary stays available to ``load_reference_model``."""
    src = _source("vector")
    _, tmodel = _models(src)
    path = str(tmp_path / "models" / "LdaModel_EN_7")
    _export(save_reference_model, tmodel, path, src)
    os.remove(str(tmp_path / "models" / "vocabularies" / "LdaModel_EN_7"))
    with pytest.raises(FileNotFoundError) as want:
        jpersistence.load_model(path)
    with pytest.raises(FileNotFoundError) as got:
        tpersistence.load_model(path, device="cpu")
    assert str(got.value) == str(want.value)
    assert "vocabulary sidecar missing" in str(got.value)
    placeholder = timport.load_reference_model(path, device="cpu")
    assert placeholder.vocab == jimport.load_reference_model(path).vocab
    assert placeholder.vocab[:2] == ["term_0", "term_1"]


def test_model_load_reads_no_edges(exported):
    """Scoring loads no doc-term edges: an MLlib dir without
    ``data/tokenCounts`` loads through ``load_model`` with the same fields,
    and only the artifacts' ``edges`` read that dataset."""
    dirs, src = exported
    shutil.rmtree(os.path.join(dirs["port"], "data", "tokenCounts"))
    _assert_model(tpersistence.load_model(dirs["port"], device="cpu"), src,
                  src["alpha"])
    art = timport.MLlibLDAArtifacts(dirs["port"])
    assert sorted(art.doc_gammas) == list(range(N_DOCS))
    with pytest.raises(FileNotFoundError, match="no parquet part files"):
        art.edges


# ---- the CLIs ---------------------------------------------------------------
@pytest.fixture
def python_text(monkeypatch):
    """The port's TextPreprocessor on its Python path, as the JAX CLI's
    runs here."""
    monkeypatch.setattr(tpipeline.TextPreprocessor, "_resolve_backend",
                        lambda self: "python")


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    """Six books of one length (EM "auto" pads them) and one book of stop
    words only (an empty document)."""
    root = tmp_path_factory.mktemp("mllib_books")
    stop = chip_smoke.en_books_dir(9, str(root), n_books=6,
                                   words=(800, 800))
    with open(stop, encoding="utf-8") as f:
        words = f.read().split(",")
    with open(root / "books" / "book_06.txt", "w", encoding="utf-8") as f:
        f.write(" ".join(words * 3) + ".")
    return str(root / "books"), stop


def _em_fits(monkeypatch):
    """The EMLDA estimators that ``fit`` in this test, in order."""
    fits = []
    fit = tem.EMLDA.fit

    def spy(self, *args, **kwargs):
        fits.append(self)
        return fit(self, *args, **kwargs)

    monkeypatch.setattr(tem.EMLDA, "fit", spy)
    return fits


def test_train_export_mllib_scores_in_both_clis(books, tmp_path, monkeypatch,
                                                python_text):
    """(f) Both CLIs' ``train --export-mllib`` from one em_state.npz, with
    the default layout: the port's fit is padded, its stdout equals the
    JAX CLI's with numbers and paths masked, and its MLlib dir (the empty
    book has a doc vertex and no edge) is scored by both CLIs' ``score
    --model`` with equal reports (floats masked) and distributions within
    atol 1e-4."""
    book_dir, stop = books
    base = str(tmp_path / "start")
    _start_state(book_dir, stop, base)
    fits = _em_fits(monkeypatch)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        ckpt, models = str(tmp_path / f"ck_{name}"), str(tmp_path / name)
        shutil.copytree(base, ckpt)
        with jax_python_text():
            rc, so, se = run(main, [
                "train", "--books", book_dir, "--stop-words", stop,
                "--k", "3", "--max-iterations", "4", "--models-dir", models,
                "--checkpoint-dir", ckpt, "--resume", "--data-shards", "1",
                "--export-mllib"])
        assert rc == 0, se
        (saved,) = [d for d in os.listdir(models) if d.endswith("_mllib")]
        outs[name] = (so, os.path.join(models, saved), ckpt, models)
    assert [f.last_layout for f in fits] == ["padded"]
    (jout, jdir, jck, jmodels), (tout, tdir, tck, tmodels) = (
        outs["jax"], outs["port"])
    assert f"MLlib-format model exported to {tdir}" in tout
    assert mask(tout, [(tck, "<ck>"), (tmodels, "<m>")]).splitlines() == \
        mask(jout, [(jck, "<ck>"), (jmodels, "<m>")]).splitlines()
    art = timport.MLlibLDAArtifacts(tdir)
    n_docs = len(os.listdir(book_dir)) - 1
    assert sorted(art.doc_gammas) == list(range(n_docs))
    assert set(art.edges[0].tolist()) == set(range(n_docs))

    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out_dir = str(tmp_path / f"o_{name}")
        with jax_python_text():
            rc, so, se = run(main, ["score", "--books", book_dir,
                                    "--stop-words", stop, "--model", tdir,
                                    "--output-dir", out_dir])
        assert rc == 0, se
        assert f"loaded model {tdir}: k=3" in so
        reports[name] = report_of(out_dir)
    assert mask(reports["port"]) == mask(reports["jax"])
    dj = chip_smoke.report_distributions(reports["jax"], 3)
    dt = chip_smoke.report_distributions(reports["port"], 3)
    assert dj.shape == (n_docs + 1, 3)
    np.testing.assert_allclose(dt, dj, atol=1e-4)


@pytest.mark.parametrize("algo_argv", [
    ["--algorithm", "online", "--sampling", "epoch", "--token-layout",
     "tiles"],
    ["--algorithm", "nmf"],
], ids=["online", "nmf"])
def test_export_mllib_skips_without_em(books, tmp_path, python_text,
                                       algo_argv):
    """(g) ``--export-mllib`` with another algorithm than EM prints the
    JAX CLI's skip line, as the JAX CLI does, and writes no MLlib dir."""
    book_dir, stop = books
    skip = ("--export-mllib requires --algorithm em (DistributedLDAModel "
            "is MLlib's EM artifact class); skipping export")
    for name, main in (("jax", jax_main), ("port", port_main)):
        models = str(tmp_path / name)
        with jax_python_text():
            rc, so, se = run(main, [
                "train", "--books", book_dir, "--stop-words", stop,
                "--k", "2", "--max-iterations", "2", "--models-dir", models,
                "--data-shards", "1", "--export-mllib", *algo_argv])
        assert rc == 0, se
        assert skip in so.splitlines(), name
        assert not [d for d in os.listdir(models) if d.endswith("_mllib")]


def test_export_mllib_without_pyarrow_fails_as_jax(books, tmp_path,
                                                   monkeypatch, python_text):
    """Where pyarrow does not import, both CLIs save the model and then
    fail in the export with the same ImportError."""
    book_dir, stop = books
    for mod in ("pyarrow", "pyarrow.parquet"):
        monkeypatch.setitem(sys.modules, mod, None)
    errors = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        models = str(tmp_path / name)
        with jax_python_text(), pytest.raises(ImportError) as exc:
            run(main, ["train", "--books", book_dir, "--stop-words", stop,
                       "--k", "2", "--max-iterations", "1", "--models-dir",
                       models, "--data-shards", "1", "--export-mllib"])
        errors[name] = str(exc.value)
        (saved,) = os.listdir(models)
        assert artifact_status(os.path.join(models, saved)) == "committed"
    assert errors["port"] == errors["jax"] == (
        "writing MLlib Parquet artifacts requires pyarrow")
