"""Scoring, model artifacts and the scoring report: the port against the
JAX package on one model.

A model saved by the JAX package is loaded by the port and both score the
same rows.  The padded layout runs the E-step kernel (the Pallas kernel in
interpret mode, ``STC_GAMMA_BACKEND=pallas``; the port's plain version on
the CPU).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.persistence import load_model as j_load
from spark_text_clustering_tpu.utils.report import (
    format_scoring_report as j_report,
)
from spark_text_clustering_tpu_torch import load_model
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.models.persistence import (
    latest_model_dir,
    model_dir_name,
)
from spark_text_clustering_tpu_torch.resilience import CorruptArtifactError
from spark_text_clustering_tpu_torch.utils.report import (
    format_scoring_report,
    java_double_str,
    write_scoring_report,
)

K, V = 5, 400


def _rows(n, seed, lo=3, hi=90):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        nnz = int(rng.integers(lo, hi))
        ids = np.sort(rng.choice(V, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.integers(1, 9, nnz).astype(np.float32)))
    return rows


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """An EM-shaped model (sparse counts with exact zeros) saved by JAX."""
    rng = np.random.default_rng(0)
    lam = rng.gamma(0.3, 20.0, (K, V)).astype(np.float32)
    lam[rng.random((K, V)) < 0.1] = 0.0
    model = JLDAModel(
        lam=lam, vocab=[f"w{i}" for i in range(V)],
        alpha=np.full((K,), 11.0, np.float32), eta=1.1, algorithm="em",
        step=50, iteration_times=[0.5, 0.25],
    )
    path = str(tmp_path_factory.mktemp("jax") / "LdaModel_EN_1000")
    model.save(path)
    return path


def _compare(got, want, atol, argmax=True):
    np.testing.assert_allclose(got, want, atol=atol)
    if argmax:
        flips = np.nonzero(got.argmax(1) != want.argmax(1))[0]
        assert flips.size == 0, f"argmax differs on docs {flips.tolist()}"


@pytest.mark.parametrize("seed", [None, 3])
def test_padded_scoring_matches_jax(jax_model_dir, monkeypatch, seed):
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    rows = _rows(21, seed=1) + [(np.zeros(0, np.int32), np.zeros(0, np.float32))]
    jm = j_load(jax_model_dir)
    tm = load_model(jax_model_dir, device="cpu")
    want = np.asarray(jm.topic_distribution(rows, layout="padded"))
    got = tm.topic_distribution(rows, layout="padded", seed=seed)
    np.testing.assert_allclose(got[-1], np.full(K, 1.0 / K), rtol=1e-6)
    # a seeded start moves the fixed point by at most ~tol
    _compare(got, want, atol=5e-3)


@pytest.mark.parametrize("layout,convergence", [("packed", "batch"),
                                                ("auto", "per_doc")])
def test_packed_scoring_matches_jax(jax_model_dir, layout, convergence):
    rows = _rows(17, seed=2)
    jm = j_load(jax_model_dir)
    tm = load_model(jax_model_dir, device="cpu")
    want = np.asarray(jm.topic_distribution(
        rows, layout="packed", convergence=convergence))
    got = tm.topic_distribution(rows, layout=layout, convergence=convergence)
    _compare(got, want, atol=1e-4)


def test_per_doc_is_batch_invariant(jax_model_dir):
    rows = _rows(9, seed=4)
    tm = load_model(jax_model_dir, device="cpu")
    full = tm.topic_distribution(rows, convergence="per_doc")
    solo = tm.topic_distribution(rows[3:4], convergence="per_doc")
    np.testing.assert_allclose(solo[0], full[3], atol=1e-6)


def test_port_artifact_loads_in_jax(tmp_path, jax_model_dir):
    tm = load_model(jax_model_dir, device="cpu")
    out = str(tmp_path / "LdaModel_EN_2000")
    tm.save(out)
    jm = j_load(out)
    src = j_load(jax_model_dir)
    np.testing.assert_array_equal(np.asarray(jm.lam), np.asarray(src.lam))
    np.testing.assert_array_equal(np.asarray(jm.alpha), np.asarray(src.alpha))
    assert jm.lam.dtype == np.float32
    assert jm.vocab == src.vocab
    with open(f"{out}/meta.json") as f, open(f"{jax_model_dir}/meta.json") as g:
        assert json.load(f) == json.load(g)
    assert (tmp_path / "LdaModel_EN_2000" / "COMMIT").exists()


def test_interop_model_matches_loaded(jax_model_dir):
    jm = j_load(jax_model_dir)
    built = lda_model_from_numpy(
        np.asarray(jm.lam), jm.alpha, jm.eta, jm.vocab, device="cpu"
    )
    loaded = load_model(jax_model_dir, device="cpu")
    rows = _rows(5, seed=6)
    np.testing.assert_array_equal(
        built.topic_distribution(rows), loaded.topic_distribution(rows)
    )


def test_corrupt_and_latest_model_dirs(tmp_path, jax_model_dir):
    tm = load_model(jax_model_dir, device="cpu")
    base = tmp_path / "models"
    good = str(base / "LdaModel_EN_100")
    tm.save(good)
    newer = base / "LdaModel_EN_200"
    tm.save(str(newer))
    (newer / "COMMIT").unlink()               # a crashed save
    assert latest_model_dir(str(base), "EN") == good
    with pytest.raises(CorruptArtifactError):
        load_model(str(newer), device="cpu")
    with open(f"{good}/arrays.npz", "ab") as f:
        f.write(b"rot")
    with pytest.raises(CorruptArtifactError):
        load_model(good, device="cpu")
    assert model_dir_name("EN", str(base)).startswith(str(base / "LdaModel_EN_"))


def test_report_is_byte_identical(jax_model_dir, tmp_path):
    rows = _rows(8, seed=7)
    jm = j_load(jax_model_dir)
    tm = load_model(jax_model_dir, device="cpu")
    dist = np.asarray(jm.topic_distribution(rows, layout="packed"))
    names = [f"/books/book,{i}.txt" for i in range(len(rows))]
    want = j_report(jm, names, dist, rows)
    got = format_scoring_report(tm, names, dist, rows)
    assert got == want
    path = write_scoring_report(got, str(tmp_path), "EN", timestamp_millis=5)
    assert path.endswith("Result_EN_5")
    with open(path, encoding="utf-8") as f:
        assert f.read() == want


@pytest.mark.parametrize("x,want", [(0.0, "0.0"), (8.448894766995838e-4,
                                                   "8.448894766995838E-4"),
                                    (0.25, "0.25"), (1e7, "1.0E7")])
def test_java_double_str(x, want):
    assert java_double_str(x) == want


def test_describe_topics_matches_jax(jax_model_dir):
    jm = j_load(jax_model_dir)
    tm = load_model(jax_model_dir, device="cpu")
    assert tm.describe_topics(12) == jm.describe_topics(12)
    assert tm.describe_topics_terms(7) == jm.describe_topics_terms(7)
    np.testing.assert_array_equal(tm.topics_matrix(), jm.topics_matrix())


def _one_bucket_rows(n, seed):
    """Rows of 33-64 distinct terms (one padded bucket of 64 slots), the
    last one empty."""
    return _rows(n - 1, seed, lo=33, hi=65) + [
        (np.zeros(0, np.int32), np.zeros(0, np.float32))]


@pytest.mark.parametrize("seed", [None, 5])
def test_topic_distribution_doc_term_batch(jax_model_dir, seed):
    """Fault S1: one pinned [8, 128] DocTermBatch of 6 rows and 2 pad rows
    (a streaming trigger's chunk) scores in the port as in the JAX
    package: every row back, pad rows uniform, within atol 5e-3 (the
    padded scoring tolerance); the real rows equal the port's row-list
    scoring of the same rows on the padded layout; per_doc refuses a
    batch in both packages, and a 1x1 grid scores it alike."""
    from spark_text_clustering_tpu.ops.sparse import (
        batch_from_rows as j_batch, pad_rows as j_pad,
    )
    from spark_text_clustering_tpu_torch.ops.sparse import (
        batch_from_rows, pad_rows,
    )
    from spark_text_clustering_tpu_torch.parallel import make_grid

    rows = _one_bucket_rows(6, seed=8)
    jm = j_load(jax_model_dir)
    tm = lda_model_from_numpy(np.asarray(jm.lam), jm.alpha, jm.eta,
                              jm.vocab, algorithm=jm.algorithm, device="cpu")
    want = np.asarray(jm.topic_distribution(
        j_batch(j_pad(rows, 8), row_len=128)))
    batch = batch_from_rows(pad_rows(rows, 8), row_len=128)
    got = tm.topic_distribution(batch, seed=seed)
    assert got.shape == want.shape == (8, K)
    np.testing.assert_allclose(got[5:], np.full((3, K), 1.0 / K), rtol=1e-6)
    _compare(got, want, atol=5e-3)
    if seed is None:
        np.testing.assert_array_equal(
            got[:6], tm.topic_distribution(rows, layout="padded"))
    np.testing.assert_array_equal(
        tm.topic_distribution(batch, seed=seed,
                              grid=make_grid(1, 1, device="cpu")), got)
    for model, b in ((jm, j_batch(j_pad(rows, 8), row_len=128)),
                     (tm, batch)):
        with pytest.raises(ValueError, match="scores row lists"):
            model.topic_distribution(b, convergence="per_doc")


@pytest.mark.parametrize("algorithm", ["em", "online"])
def test_log_likelihood_doc_term_batch(jax_model_dir, algorithm):
    """Fault L1: ``log_likelihood`` and ``log_perplexity`` take one pinned
    [8, 64] DocTermBatch of 6 rows and 2 pad rows as it is, in both
    packages, from one lambda and all-ones gamma inits: the port agrees
    with the JAX package within 1e-4 relative, each package's batch
    result equals its own row-list result within 1e-6 relative (pad rows
    add nothing to the bound), and a 1x1 grid agrees with one device."""
    from spark_text_clustering_tpu.ops.sparse import (
        batch_from_rows as j_batch, pad_rows as j_pad,
    )
    from spark_text_clustering_tpu_torch.ops.sparse import (
        batch_from_rows, pad_rows,
    )
    from spark_text_clustering_tpu_torch.parallel import make_grid

    rows = _rows(6, seed=9, lo=20, hi=65)
    src = j_load(jax_model_dir)
    jm = JLDAModel(lam=np.asarray(src.lam), vocab=src.vocab,
                   alpha=src.alpha, eta=src.eta, algorithm=algorithm)
    tm = lda_model_from_numpy(np.asarray(src.lam), src.alpha, src.eta,
                              src.vocab, algorithm=algorithm, device="cpu")
    jb = j_batch(j_pad(rows, 8), row_len=64)
    tb = batch_from_rows(pad_rows(rows, 8), row_len=64)
    want = (jm.log_likelihood(jb), jm.log_perplexity(jb))
    got = (tm.log_likelihood(tb), tm.log_perplexity(tb))
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        want, (jm.log_likelihood(rows), jm.log_perplexity(rows)), rtol=1e-6)
    np.testing.assert_allclose(
        got, (tm.log_likelihood(rows), tm.log_perplexity(rows)), rtol=1e-6)
    grid = make_grid(1, 1, device="cpu")
    np.testing.assert_allclose(
        (tm.log_likelihood(tb, grid=grid), tm.log_perplexity(tb, grid=grid)),
        got, rtol=1e-6)
