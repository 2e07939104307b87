"""The port's online-VB fit (tiles-resident path) held against the JAX
package's.

Torch cannot reproduce JAX's threefry draws, so the iteration parity test
starts both packages from one lambda in ``train_state.npz`` and feeds the
port the JAX package's own gamma inits (``init_gamma_rows``).  The JAX
side runs its tile kernel in interpret mode on a 1x1 CPU mesh; the port
runs with ``device="cpu"``, which takes the kernel's plain version.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.online_lda import (
    OnlineLDA as JOnlineLDA,
    TrainState,
    make_online_tiles_resident_chunk,
)
from spark_text_clustering_tpu.models.persistence import (
    load_model as j_load_model,
    load_train_state as j_load_train_state,
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.ops.lda_math import (
    approx_bound as j_approx_bound,
    init_gamma_rows,
)
from spark_text_clustering_tpu.ops.sparse import (
    batch_from_rows as j_batch_from_rows,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu_torch import LDA, OnlineLDA, Params, load_model
from spark_text_clustering_tpu_torch.interop import (
    lda_model_from_numpy,
    online_state_from_numpy,
)
from spark_text_clustering_tpu_torch.models.online_lda import tiles_iteration
from spark_text_clustering_tpu_torch.models.persistence import load_train_state
from spark_text_clustering_tpu_torch.ops.lda_math import approx_bound
from spark_text_clustering_tpu_torch.ops.packed import plan_corpus_tiles
from spark_text_clustering_tpu_torch.ops.sparse import batch_from_rows

TAU0, KAPPA, SHAPE = 1024.0, 0.51, 100.0


def _mesh():
    return make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])


def _planted(n_docs=160, v=200, seed=11):
    """Two planted topics over disjoint vocab halves."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_docs):
        lo, hi = (0, v // 2) if i % 2 == 0 else (v // 2, v)
        nnz = int(rng.integers(5, 14))
        ids = rng.choice(np.arange(lo, hi), size=nnz, replace=False)
        rows.append((ids.astype(np.int32),
                     rng.integers(1, 5, size=nnz).astype(np.float32)))
    return rows, [f"t{i}" for i in range(v)]


def _skewed(n_docs=200, v=1000, seed=7):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_docs):
        nnz = int(np.clip(rng.lognormal(2.5, 1.0), 1, 300))
        ids = np.sort(rng.choice(v, size=nnz, replace=False))
        rows.append((ids.astype(np.int32),
                     rng.integers(1, 6, size=nnz).astype(np.float32)))
    return rows, [f"t{i}" for i in range(v)]


def _params(**kw):
    base = dict(k=2, algorithm="online", max_iterations=12, sampling="epoch",
                token_layout="tiles", seed=0)
    base.update(kw)
    return base


def test_iteration_matches_jax(tmp_path):
    """Three iterations of the JAX tiles-resident chunk and of the port's
    iteration from one lambda (written by JAX to train_state.npz, read by
    the port), with the JAX gamma inits: lambda within rtol 1e-4 (measured
    ~1.3e-5; the tile fixed point and the scatter sum in other orders)."""
    rows, vocab = _skewed()
    k, v, n = 5, len(vocab), len(rows)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
    plan = plan_corpus_tiles(np.concatenate([i for i, _ in rows]),
                             np.concatenate([w for _, w in rows]), offsets, k=k)
    n_real = int((plan.doc_ids[:, 0] < n).sum())
    assert n_real >= 3
    picks = np.array([[[0, 2]], [[1, n_real - 1]], [[2, 1]]], np.int32)
    lam0 = np.random.default_rng(3).gamma(SHAPE, 1 / SHAPE, (k, v))
    path = str(tmp_path / "train_state.npz")
    j_save_train_state(path, 0, lam=lam0.astype(np.float32))
    lam0 = load_train_state(path, require=("lam",))["lam"]

    alpha = np.full((k,), 1.0 / k, np.float32)
    mesh = _mesh()
    run = make_online_tiles_resident_chunk(
        mesh, alpha=alpha, eta=1.0 / k, tau0=TAU0, kappa=KAPPA, k=k,
        gamma_shape=SHAPE, seed=0, d=plan.d, n_docs=n, interpret=True,
        gamma_backend="pallas")
    spec = NamedSharding(mesh, P("data", None))
    res = [jax.device_put(a, spec)
           for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids)]
    pick_spec = NamedSharding(mesh, P(None, "data", None))
    want = run(TrainState(jnp.asarray(lam0), jnp.asarray(0, jnp.int32)),
               *res, jax.device_put(picks, pick_spec), float(n))
    lam = torch.from_numpy(lam0)
    for step, pick in enumerate(picks[:, 0]):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        g0 = np.asarray(init_gamma_rows(
            key, jnp.asarray(plan.doc_ids[pick].reshape(-1)), k, SHAPE)).T
        lam = tiles_iteration(
            lam, step, torch.from_numpy(plan.ids[pick]),
            torch.from_numpy(plan.cts[pick]), torch.from_numpy(plan.seg[pick]),
            torch.from_numpy(np.ascontiguousarray(g0)),
            int((plan.doc_ids[pick] < n).sum()),
            alpha=torch.from_numpy(alpha), eta=1.0 / k, tau0=TAU0,
            kappa=KAPPA, d=plan.d, corpus_size=float(n))
    assert int(want.step) == 3
    np.testing.assert_allclose(lam.numpy(), np.asarray(want.lam), rtol=1e-4)


def test_tile_stream_matches_jax():
    """The block-stratified tile stream, the batch accounting and the
    geometry equal the JAX package's over two epochs."""
    rows, vocab = _skewed()
    kw = _params(k=5, max_iterations=1)
    jopt = JOnlineLDA(JParams(**kw), mesh=_mesh())
    jopt.fit(rows, vocab)
    topt = OnlineLDA(Params(**kw), device="cpu")
    topt.fit(rows, vocab)
    assert topt.last_batch_size == jopt.last_batch_size
    assert topt.last_layout == jopt.last_layout == "tiles_resident"
    assert topt.last_tiles == jopt.last_tiles
    tiles = topt.last_tiles
    iters = 2 * -(-tiles["reals_per_shard"][0] // tiles["tiles_per_iter"])
    for i in range(iters):
        np.testing.assert_array_equal(topt.tile_pick(i), jopt.tile_pick(i))


def test_whole_fit_matches_jax():
    """60 iterations of each package on the planted-topics corpus (each
    from its own random draws): both recover the two planted topics, and
    their log-perplexities agree within 3% (measured 1.6% at this seed;
    the JAX package's tiles-vs-packed quality band is 5%)."""
    rows, vocab = _planted()
    kw = _params(max_iterations=60)
    jmodel = JOnlineLDA(JParams(**kw), mesh=_mesh()).fit(rows, vocab)
    tmodel = OnlineLDA(Params(**kw), device="cpu").fit(rows, vocab)
    assert tmodel.algorithm == "online" and tmodel.step == 60
    v = len(vocab)
    for model in (tmodel, jmodel):
        lo_mass = model.topics_matrix()[:, : v // 2].sum(axis=1)
        assert (lo_mass > 0.85).any() and (lo_mass < 0.15).any()
    lp_t = tmodel.log_perplexity(rows, device="cpu")
    lp_j = jmodel.log_perplexity(rows)
    assert abs(lp_t - lp_j) / abs(lp_j) < 0.03


@pytest.mark.parametrize("algorithm", ["online", "em"])
def test_bound_matches_jax(algorithm, monkeypatch):
    """One model evaluated by both packages: ``approx_bound`` on the same
    gamma, and ``log_perplexity`` (each package's gamma fixed point with
    the same per-tile stop rule), within 1e-5 relative: the bound is a
    float32 sum of ~4,000 topic-term values whose partial sums are ~10x
    the result, added in another order by each package (measured 2e-6).
    EM models are evaluated at lam + eta in both."""
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    rows, vocab = _skewed(n_docs=60)
    k = 4
    rng = np.random.default_rng(2)
    lam = rng.gamma(2.0, 3.0, (k, len(vocab))).astype(np.float32)
    alpha, eta = (0.25, 0.25) if algorithm == "online" else (13.5, 1.1)
    tmodel = lda_model_from_numpy(lam, alpha, eta, vocab,
                                  algorithm=algorithm, device="cpu")
    jmodel = JLDAModel(lam=lam, vocab=vocab, alpha=tmodel.alpha, eta=eta,
                       algorithm=algorithm)
    lp_t = tmodel.log_perplexity(rows)
    lp_j = jmodel.log_perplexity(rows)
    assert lp_t == pytest.approx(lp_j, rel=1e-5)

    gamma = rng.gamma(5.0, 1.0, (len(rows), k)).astype(np.float32)
    want = float(j_approx_bound(j_batch_from_rows(rows), jnp.asarray(gamma),
                                jnp.asarray(lam), jnp.asarray(tmodel.alpha),
                                eta, 60.0, 60.0))
    got = float(approx_bound(batch_from_rows(rows), torch.from_numpy(gamma),
                             torch.from_numpy(lam),
                             torch.from_numpy(tmodel.alpha), eta, 60.0, 60.0))
    assert got == pytest.approx(want, rel=1e-5)


def test_resume_matches_uninterrupted(tmp_path):
    """A fit checkpointed at iteration 4 and resumed to 8 ends at the same
    lambda as an uninterrupted 8-iteration fit; the checkpoint is the JAX
    package's train_state.npz, and a lambda written there from numpy
    (``online_state_from_numpy``) resumes the same way."""
    rows, vocab = _planted()
    full = OnlineLDA(Params(**_params(max_iterations=8)), device="cpu").fit(
        rows, vocab)
    ck = str(tmp_path / "ck")
    kw = _params(max_iterations=8, checkpoint_dir=ck, checkpoint_interval=4)
    OnlineLDA(Params(**kw), device="cpu").fit(rows, vocab, max_iterations=4)
    state = j_load_train_state(os.path.join(ck, "train_state.npz"))
    assert state["step"] == 4 and state["lam"].shape == (2, len(vocab))
    resumed = OnlineLDA(Params(**kw), device="cpu").fit(rows, vocab)
    assert resumed.step == full.step == 8
    np.testing.assert_allclose(resumed.lam, full.lam, rtol=1e-6, atol=1e-7)

    ck2 = str(tmp_path / "ck2")
    online_state_from_numpy(ck2, state["lam"], step=4)
    again = OnlineLDA(Params(**dict(kw, checkpoint_dir=ck2)),
                      device="cpu").fit(rows, vocab)
    np.testing.assert_array_equal(again.lam, resumed.lam)


def test_online_model_persistence_both_ways(tmp_path):
    """An online model the port saves loads in the JAX package, and one
    the JAX package saves loads in the port, with lam, priors, step and
    algorithm intact."""
    rows, vocab = _planted(n_docs=40)
    kw = _params(max_iterations=3)
    tmodel = OnlineLDA(Params(**kw), device="cpu").fit(rows, vocab)
    tmodel.save(str(tmp_path / "port"))
    jback = j_load_model(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jback.lam), tmodel.lam)
    assert jback.algorithm == "online" and jback.step == 3
    jmodel = JOnlineLDA(JParams(**kw), mesh=_mesh()).fit(rows, vocab)
    jmodel.save(str(tmp_path / "jax"))
    tback = load_model(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(tback.lam, np.asarray(jmodel.lam))
    np.testing.assert_array_equal(tback.alpha, np.asarray(jmodel.alpha))
    assert (tback.algorithm, tback.step, tback.eta) == (
        "online", 3, pytest.approx(0.5))


def test_pipeline_lda_online():
    rows, vocab = _planted(n_docs=40)
    ds = {"rows": rows + [(np.zeros(0, np.int32), np.zeros(0, np.float32))],
          "vocab": vocab}
    fitted = LDA(Params(**_params(max_iterations=4)), device="cpu").fit(ds)
    assert fitted.model.algorithm == "online" and fitted.corpus_size == 40
    out = fitted.transform(ds)
    assert out["topic_distribution"].shape == (41, 2)
    with pytest.raises(ValueError, match="unknown algorithm"):
        LDA(Params(algorithm="lsa"), device="cpu").fit(ds)


_UNPORTED = [
    ("sharded", dict(data_shards=2), ValueError, "needs 2 ranks"),
    ("tiles_needs_epoch", dict(sampling="fixed"), ValueError, "epoch"),
]


@pytest.mark.parametrize("name,kw,exc,match", _UNPORTED,
                         ids=[c[0] for c in _UNPORTED])
def test_unported_paths_raise(name, kw, exc, match):
    """Shards without the ranks of a started grid raise, naming the ranks
    the grid needs, and the tiles layout without epoch sampling is
    refused, instead of falling back."""
    rows, vocab = _planted(n_docs=40)
    with pytest.raises(exc, match=match):
        OnlineLDA(Params(**_params(**kw)), device="cpu").fit(rows, vocab)
