"""The port's IDF stage and EM fit held against the JAX package.

Both EM fits resume from ONE ``em_state.npz`` written by the JAX
package's ``save_train_state`` (the two packages draw different random
inits, so the start is injected).  The JAX fit runs its Pallas kernels in
interpret mode on a 1x1 CPU mesh (``STC_GAMMA_BACKEND=pallas``); the port
fits with ``device="cpu"``, which runs its kernels' plain versions.
"""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest

from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.em_lda import EMLDA as JEMLDA
from spark_text_clustering_tpu.models.persistence import (
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu.pipeline import IDF as JIDF
from spark_text_clustering_tpu_torch import EMLDA, IDF, Params
from spark_text_clustering_tpu_torch.interop import em_state_from_numpy
from spark_text_clustering_tpu_torch.models.persistence import load_train_state

K = 4


def _corpus(n_docs, v, lo, hi, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_docs):
        nnz = int(rng.integers(lo, hi))
        ids = np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, (rng.random(nnz) * 3 + 0.2).astype(np.float32)))
    return rows, [f"t{i}" for i in range(v)]


def _init_state(rows, v, k, seed):
    """A random soft assignment as numpy counts (n_wk [k, V], n_dk [n, k])."""
    rng = np.random.default_rng(seed)
    n_wk = np.zeros((k, v), np.float32)
    n_dk = np.zeros((len(rows), k), np.float32)
    for d, (ids, w) in enumerate(rows):
        phi = rng.exponential(size=(len(ids), k)).astype(np.float32)
        wphi = w[:, None] * phi / phi.sum(1, keepdims=True)
        n_dk[d] = wphi.sum(0)
        np.add.at(n_wk.T, ids, wphi)
    return n_wk, n_dk


def _fit_both(tmp_path, monkeypatch, rows, vocab, iters):
    n_wk, n_dk = _init_state(rows, len(vocab), K, seed=7)
    base = tmp_path / "base"
    j_save_train_state(str(base / "em_state.npz"), 0, n_wk=n_wk, n_dk=n_dk)
    shutil.copytree(base, tmp_path / "jax")
    shutil.copytree(base, tmp_path / "torch")

    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    mesh = make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])
    jopt = JEMLDA(
        JParams(k=K, max_iterations=iters, token_layout="packed",
                checkpoint_dir=str(tmp_path / "jax"), checkpoint_interval=100),
        mesh=mesh,
    )
    jmodel = jopt.fit(rows, vocab)
    topt = EMLDA(
        Params(k=K, max_iterations=iters,
               checkpoint_dir=str(tmp_path / "torch"),
               checkpoint_interval=100),
        device="cpu",
    )
    tmodel = topt.fit(rows, vocab)
    return jopt, jmodel, topt, tmodel


@pytest.mark.parametrize("branch", ["fused", "two_stage"])
@pytest.mark.parametrize("iters", [5, 50])
def test_em_fit_matches_jax_from_one_checkpoint(
    tmp_path, monkeypatch, branch, iters
):
    """After 5 sweeps lam within rtol 1e-4 and avg logLik within 1e-5;
    after 50 sweeps avg logLik within 1e-3 (EM amplifies the summation
    order).  The two-stage branch is reached with a doc axis > 512."""
    if branch == "fused":
        rows, vocab = _corpus(40, 900, 4, 60, seed=3)
    else:
        rows, vocab = _corpus(600, 400, 3, 12, seed=5)
    jopt, jmodel, topt, tmodel = _fit_both(
        tmp_path, monkeypatch, rows, vocab, iters
    )
    assert topt.last_sweep == branch
    assert jopt.last_scatter_backend == (
        "pallas_fused" if branch == "fused" else "pallas_vtiles"
    )
    assert tmodel.step == jmodel.step == iters
    n = len(rows)
    j_avg = jopt.last_log_likelihood / n
    t_avg = topt.last_log_likelihood / n
    if iters == 5:
        np.testing.assert_allclose(tmodel.lam, np.asarray(jmodel.lam),
                                   rtol=1e-4)
        assert t_avg == pytest.approx(j_avg, rel=1e-5)
    else:
        assert t_avg == pytest.approx(j_avg, rel=1e-3)


def test_em_checkpoint_layout_matches_jax(tmp_path):
    """The port writes the JAX package's em_state.npz (+ .sha256) and a
    later fit resumes from it at the saved step."""
    rows, vocab = _corpus(20, 300, 4, 30, seed=9)
    opt = EMLDA(Params(k=K, max_iterations=4, checkpoint_dir=str(tmp_path),
                       checkpoint_interval=2), device="cpu")
    m = opt.fit(rows, vocab)
    from spark_text_clustering_tpu.models.persistence import (
        load_train_state as j_load,
    )

    st = j_load(str(tmp_path / "em_state.npz"), require=("n_wk", "n_dk"))
    assert st["step"] == 4
    assert st["n_wk"].shape == (K, 300) and st["n_dk"].shape == (20, K)
    np.testing.assert_array_equal(st["n_wk"], m.lam)
    again = EMLDA(Params(k=K, max_iterations=6, checkpoint_dir=str(tmp_path),
                         checkpoint_interval=2), device="cpu").fit(rows, vocab)
    assert again.step == 6


def test_em_resume_from_numpy_state(tmp_path):
    rows, vocab = _corpus(10, 200, 4, 20, seed=11)
    n_wk, n_dk = _init_state(rows, 200, K, seed=1)
    path = em_state_from_numpy(str(tmp_path), n_wk, n_dk, step=3)
    assert load_train_state(path)["step"] == 3
    # ten docs of similar length: "auto" would take the padded path
    m = EMLDA(Params(k=K, max_iterations=5, checkpoint_dir=str(tmp_path),
                     checkpoint_interval=100, token_layout="packed"),
              device="cpu").fit(rows, vocab)
    assert m.step == 5 and len(m.iteration_times) == 2


def _layout_rows(lens, seed=0):
    """Rows of the given lengths; only the lengths matter to the layout."""
    rng = np.random.default_rng(seed)
    return [(np.arange(n, dtype=np.int32),
             (rng.random(n) + 0.5).astype(np.float32)) for n in lens]


def _layout_lens(case):
    rng = np.random.default_rng(4)
    if case == "similar":               # one bucket, little padding
        return rng.integers(10, 16, 30)
    if case == "skewed":                # one wide doc among short ones
        return np.concatenate([rng.integers(3, 9, 200), [900]])
    if case == "two_buckets":           # padding near 2x, no bucketing
        return np.concatenate([np.full(40, 8), np.full(40, 16)])
    if case == "empty_doc":
        return np.concatenate([[0], rng.integers(1, 40, 50)])
    # > 16M single-bucket cells, bucketing removes most of them
    return np.concatenate([rng.integers(4, 16, 8000), [4096]])


@pytest.mark.parametrize("case", ["similar", "skewed", "two_buckets",
                                  "empty_doc", "bucketed_over_16M"])
def test_em_layout_decision_matches_jax(case):
    """The padded cells and the "auto" choice equal the JAX fit's
    (``EMLDA._plan_shape`` on a 1x1 mesh, then its 2x-nnz rule)."""
    from spark_text_clustering_tpu_torch.models.em_lda import (
        em_layout, em_padded_cells,
    )

    rows = _layout_rows(_layout_lens(case))
    mesh = make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])
    shape = JEMLDA(JParams(k=K, token_layout="auto"), mesh=mesh)._plan_shape(
        rows, len(rows))
    cells = sum(len(idxs) * width for width, idxs in shape)
    nnz = sum(len(i) for i, _ in rows)
    want = "packed" if cells >= 2.0 * max(1, nnz) else "padded"
    assert em_padded_cells(rows) == cells
    assert em_layout(rows, "auto") == want
    if case == "bucketed_over_16M":
        assert len(rows) * 4096 > 16_000_000 and len(shape) > 1
    assert em_layout(rows, "packed") == "packed"
    assert em_layout(rows, "padded") == "padded"


@pytest.mark.parametrize("mode", [True, False])
@pytest.mark.parametrize("case", ["skewed", "two_buckets",
                                  "bucketed_over_16M"])
def test_em_layout_decision_follows_bucket_by_length(case, mode):
    """With ``Params.bucket_by_length`` forced on or off, the padded cells
    and the "auto" choice still equal the JAX fit's."""
    from spark_text_clustering_tpu_torch.models.em_lda import (
        em_layout, em_padded_cells,
    )

    rows = _layout_rows(_layout_lens(case))
    mesh = make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])
    shape = JEMLDA(JParams(k=K, token_layout="auto", bucket_by_length=mode),
                   mesh=mesh)._plan_shape(rows, len(rows))
    cells = sum(len(idxs) * width for width, idxs in shape)
    nnz = sum(len(i) for i, _ in rows)
    want = "packed" if cells >= 2.0 * max(1, nnz) else "padded"
    assert em_padded_cells(rows, mode) == cells
    assert em_layout(rows, "auto", mode) == want


@pytest.mark.parametrize("layout,lens,exc", [
    ("bogus", None, ValueError),
    ("padded", None, None),
    ("auto", "similar", None),
    ("auto", "skewed", None),
])
def test_em_fit_token_layout(layout, lens, exc):
    """An unknown layout raises ValueError as in JAX; "padded", and "auto"
    where the JAX fit pads, fit on the padded layout; "auto" packs where
    JAX packs."""
    rows = _layout_rows(_layout_lens(lens or "skewed"))
    vocab = [f"t{i}" for i in range(900)]
    opt = EMLDA(Params(k=K, max_iterations=2, token_layout=layout),
                device="cpu")
    if exc is None:
        m = opt.fit(rows, vocab)
        want = "padded" if layout == "padded" or lens == "similar" else "fused"
        assert opt.last_sweep == want and np.isfinite(m.lam).all()
        assert opt.last_layout == ("packed" if want == "fused" else "padded")
        assert np.isfinite(opt.last_log_likelihood)
    else:
        with pytest.raises(exc, match="token_layout"):
            opt.fit(rows, vocab)


@pytest.mark.parametrize("mode", ["auto", True, False])
@pytest.mark.parametrize("case", ["similar", "skewed", "two_buckets",
                                  "empty_doc"])
def test_em_padded_shape_matches_jax(case, mode):
    """The padded plan's buckets (width, doc indices) equal the JAX fit's
    ``_plan_shape`` on a 1x1 mesh."""
    from spark_text_clustering_tpu_torch.models.em_lda import em_padded_shape

    rows = _layout_rows(_layout_lens(case))
    mesh = make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])
    want = JEMLDA(JParams(k=K, bucket_by_length=mode),
                  mesh=mesh)._plan_shape(rows, len(rows))
    assert em_padded_shape(rows, mode) == [(w, list(i)) for w, i in want]


def _padded_rows(bucketed):
    """Docs of similar length (one bucket), or of 5-100 terms over five
    power-of-two buckets."""
    if bucketed:
        return _corpus(40, 300, 5, 100, seed=21)
    return _corpus(30, 500, 40, 60, seed=3)


def _padded_fits(tmp_path, monkeypatch, rows, vocab, m, bucketed):
    """The JAX padded fit and the port's, m sweeps each from one
    JAX-written em_state.npz, checkpointing every sweep."""
    n_wk, n_dk = _init_state(rows, len(vocab), K, seed=7)
    for name in ("jax", "torch"):
        j_save_train_state(str(tmp_path / name / "em_state.npz"), 0,
                           n_wk=n_wk, n_dk=n_dk)
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    mesh = make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])
    common = dict(k=K, max_iterations=m, token_layout="padded",
                  bucket_by_length=bucketed, checkpoint_interval=1,
                  keep_doc_topic_counts=True)
    jopt = JEMLDA(JParams(checkpoint_dir=str(tmp_path / "jax"), **common),
                  mesh=mesh)
    jopt.fit(rows, vocab)
    topt = EMLDA(Params(checkpoint_dir=str(tmp_path / "torch"), **common),
                 device="cpu")
    topt.fit(rows, vocab)
    return jopt, topt


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one_bucket", "buckets"])
def test_em_padded_fit_matches_jax_each_sweep(tmp_path, monkeypatch,
                                              bucketed, m):
    """After each of m = 1..5 sweeps from one JAX checkpoint, the padded
    fits' checkpointed n_wk and n_dk (corpus order) agree within rtol
    1e-4, the kept doc-topic counts are n_dk in corpus order, and the
    average log-likelihoods agree within 1e-5 relative."""
    from spark_text_clustering_tpu.models.persistence import (
        load_train_state as j_load,
    )
    from spark_text_clustering_tpu_torch.models.em_lda import em_padded_shape

    rows, vocab = _padded_rows(bucketed)
    assert len(em_padded_shape(rows, bucketed)) == (5 if bucketed else 1)
    jopt, topt = _padded_fits(tmp_path, monkeypatch, rows, vocab, m,
                              bucketed)
    assert jopt.last_layout == topt.last_layout == "padded"
    assert topt.last_sweep == "padded"
    js = j_load(str(tmp_path / "jax" / "em_state.npz"))
    ts = load_train_state(str(tmp_path / "torch" / "em_state.npz"))
    assert js["step"] == ts["step"] == m
    np.testing.assert_allclose(ts["n_wk"], js["n_wk"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts["n_dk"], js["n_dk"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(topt.last_doc_topic_counts, ts["n_dk"])
    np.testing.assert_allclose(topt.last_doc_topic_counts,
                               jopt.last_doc_topic_counts, rtol=1e-4,
                               atol=1e-6)
    n = len(rows)
    assert topt.last_log_likelihood / n == pytest.approx(
        jopt.last_log_likelihood / n, rel=1e-5)


@pytest.mark.parametrize("first,then", [("padded", "packed"),
                                        ("packed", "padded")])
def test_em_checkpoint_resumes_across_layouts(tmp_path, first, then):
    """A checkpoint one layout wrote after 3 sweeps resumes a fit on the
    other layout; after 6 sweeps in all it agrees with 6 uninterrupted
    sweeps on the first layout within rtol 1e-4."""
    rows, vocab = _padded_rows(False)
    ckpt = str(tmp_path / "ckpt")
    common = dict(k=K, seed=4, checkpoint_interval=3)
    EMLDA(Params(max_iterations=3, token_layout=first, checkpoint_dir=ckpt,
                 **common), device="cpu").fit(rows, vocab)
    resumed = EMLDA(Params(max_iterations=6, token_layout=then,
                           checkpoint_dir=ckpt, **common), device="cpu")
    m = resumed.fit(rows, vocab)
    assert resumed.last_layout == then and m.step == 6
    assert len(m.iteration_times) == 3
    whole = EMLDA(Params(max_iterations=6, token_layout=first, **common),
                  device="cpu").fit(rows, vocab)
    np.testing.assert_allclose(m.lam, whole.lam, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one_bucket", "buckets"])
def test_em_padded_and_packed_share_the_init(bucketed):
    """From one Params.seed the padded and the packed fit start from the
    same counts and agree within rtol 1e-4 after 5 sweeps, the kept
    doc-topic counts and the log-likelihood too."""
    rows, vocab = _padded_rows(bucketed)
    fits = {}
    for layout in ("padded", "packed"):
        opt = EMLDA(Params(k=K, max_iterations=5, seed=11,
                           token_layout=layout, bucket_by_length=bucketed,
                           keep_doc_topic_counts=True), device="cpu")
        fits[layout] = (opt, opt.fit(rows, vocab))
    (pad, mpad), (pk, mpk) = fits["padded"], fits["packed"]
    assert pad.last_sweep == "padded" and pk.last_sweep == "fused"
    np.testing.assert_allclose(mpad.lam, mpk.lam, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pad.last_doc_topic_counts,
                               pk.last_doc_topic_counts, rtol=1e-4, atol=1e-6)
    assert pad.last_log_likelihood == pytest.approx(pk.last_log_likelihood,
                                                    rel=1e-5)


def test_idf_matches_jax():
    rows, vocab = _corpus(30, 500, 5, 120, seed=2)
    ds = {"rows": rows, "vocab": vocab}
    jm = JIDF(min_doc_freq=2, idf_floor=1e-4).fit(ds)
    tm = IDF(min_doc_freq=2, idf_floor=1e-4, device="cpu").fit(ds)
    np.testing.assert_allclose(tm.idf, np.asarray(jm.idf), rtol=1e-6)
    jrows = jm.transform(ds)["rows"]
    trows = tm.transform(ds)["rows"]
    for (ji, jw), (ti, tw) in zip(jrows, trows):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tw, jw, rtol=1e-6)


def test_count_vectorizer_matches_jax():
    from spark_text_clustering_tpu.pipeline import (
        CountVectorizer as JCountVectorizer,
    )
    from spark_text_clustering_tpu_torch import CountVectorizer

    rng = np.random.default_rng(12)
    words = [f"w{i}" for i in range(60)]
    tokens = [list(rng.choice(words, size=int(rng.integers(0, 40))))
              for _ in range(25)]
    ds = {"tokens": tokens}
    jm = JCountVectorizer(vocab_size=40, num_workers=1).fit(ds)
    tm = CountVectorizer(vocab_size=40).fit(ds)
    assert tm.vocab == jm.vocab
    jrows = jm.transform(ds)["rows"]
    trows = tm.transform(ds)["rows"]
    assert len(trows) == len(jrows) == len(tokens)
    for (ji, jw), (ti, tw) in zip(jrows, trows):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
