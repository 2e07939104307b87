"""Online VB and NMF on the port's (data, model) process grid, held
against the JAX package's mesh on the CPU.

As in ``test_torch_sharding.py``, ``parallel.run_grid`` spawns each grid
shape once, (1, 2), (2, 1) and (2, 2), over gloo, one torch thread a
rank, and every rank runs ``torch_grid_online_worker.suite``.  The JAX
package runs its fits on a mesh of as many of the 8 virtual CPU devices,
in this process: its online fit drives the factories of each path
(``make_online_tiles_resident_chunk``, ``make_online_packed_tiles_chunk``,
``make_online_packed_chunk``, ``make_online_resident_chunk``, and
``make_online_eb`` / ``estep`` / ``mstep`` for the host buckets), and the
NMF checks call ``make_nmf_train_step`` and ``make_nmf_packed_runner``.

Torch cannot replay JAX's threefry draws, so each online parity fit
starts both packages from one lambda in ``train_state.npz`` and the port
reads the JAX package's gamma inits (``init_gamma_rows``) of every doc id;
NMF starts both from one W0 and H0.  Where JAX's gamma loop stops per
tile (its Pallas kernels, interpret mode) the port's plain versions do
too, and where it runs the whole-batch segment loop the port runs that.
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.nmf import (
    NMF as JNMF,
    NMFTrainState,
    frobenius_loss as j_frobenius_loss,
    make_nmf_packed_runner,
    make_nmf_train_step,
)
from spark_text_clustering_tpu.models.online_lda import OnlineLDA as JOnlineLDA
from spark_text_clustering_tpu.models.persistence import (
    load_train_state as j_load_train_state,
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.ops.lda_math import init_gamma_rows
from spark_text_clustering_tpu.ops.pallas_packed import (
    plan_corpus_tiles as j_plan_corpus_tiles,
)
from spark_text_clustering_tpu.ops.sparse import batch_from_rows as jbatch
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu.parallel.collectives import data_shard_batch
from spark_text_clustering_tpu.parallel.mesh import model_sharding
from spark_text_clustering_tpu_torch import NMF, OnlineLDA, Params
from spark_text_clustering_tpu_torch.parallel import run_grid

import torch_grid_online_worker as worker

K, V, SEED, ITERS, SWEEPS = 5, 400, 0, 3, 5
SHAPES = [(1, 2), (2, 1), (2, 2)]
IDS = ["1x2", "2x1", "2x2"]

# each online path: corpus, Params, the port's rule, JAX's gamma backend
ONLINE = {
    "tiles_resident": ("skewed", dict(sampling="epoch", token_layout="tiles"),
                       "cpu", None),
    "packed_tiles": ("skewed", dict(sampling="fixed", token_layout="packed"),
                     "card", "pallas"),
    "packed_flat": ("skewed", dict(sampling="fixed", token_layout="packed"),
                    "cpu", None),
    "padded_resident": ("even", dict(sampling="fixed", token_layout="padded",
                                     device_resident=True, batch_size=12),
                        "cpu", "pallas"),
    "padded_host": ("even", dict(sampling="bernoulli", token_layout="padded",
                                 device_resident=False), "cpu", "pallas"),
}
# (shape, path): every path on the 2x2 grid, which shards both axes; on
# one axis the padded host path (its buckets' E-step is the resident
# path's) and, where no data axis is sharded, the padded resident path
# stay out, which keeps the file's JAX compiles near a minute
PATH_CASES = [(shape, name) for shape in SHAPES for name in sorted(ONLINE)
              if shape == (2, 2) or not (
                  name == "padded_host"
                  or (name == "padded_resident" and shape[0] == 1))]
PATH_IDS = [f"{d}x{m}-{name}" for (d, m), name in PATH_CASES]
NMF_CASES = {"padded": ("even", "padded", False),
             "tiles": ("skewed", "packed", False),
             "flat": ("skewed", "packed", True)}


def _corpus(n_docs, v, seed, lengths):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_docs):
        nnz = int(lengths(rng))
        ids = np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.integers(1, 6, size=nnz).astype(np.float32)))
    return rows


def _mesh(shape):
    d, m = shape
    return make_mesh(d, m, devices=jax.devices("cpu")[:d * m])


def _jax_g0(n_ids, seed=SEED, steps=ITERS):
    """JAX's gamma inits [steps, n_ids, K] of doc ids 0..n_ids-1."""
    return np.stack([np.array(init_gamma_rows(
        jax.random.fold_in(jax.random.PRNGKey(seed), step),
        jnp.arange(n_ids), K, 100.0)) for step in range(steps)])


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Every input the ranks take: corpora, the JAX inits, one lambda in a
    JAX-written train_state.npz, NMF starts, the checkpoint dirs the 2x2
    grid writes."""
    root = tmp_path_factory.mktemp("grid_online")
    corpora = {
        "skewed": _corpus(300, V, 7, lambda r: np.clip(r.lognormal(2.5, 1.0),
                                                       1, 200)),
        "even": _corpus(64, V, 9, lambda r: r.integers(20, 41)),
    }
    start = str(root / "start")
    lam = np.random.default_rng(3).gamma(100.0, 0.01, (K, V))
    j_save_train_state(os.path.join(start, "train_state.npz"), 0,
                       lam=lam.astype(np.float32))
    base = dict(k=K, seed=SEED, max_iterations=ITERS, checkpoint_dir=start,
                checkpoint_interval=100)
    rng = np.random.default_rng(5)
    nmf_init = {}
    for name, rows in corpora.items():
        scale = np.sqrt(np.mean([w.mean() for _, w in rows]) / V / K)
        nmf_init[name] = (
            (scale * (0.5 + rng.random((len(rows), K)))).astype(np.float32),
            (scale * (0.5 + rng.random((K, V)))).astype(np.float32))
    seed_kw = dict(k=K, seed=5, max_iterations=ITERS, sampling="fixed",
                   batch_size=16)
    return {
        "v": V, "corpora": corpora, "start": start,
        "g0": {name: _jax_g0(len(rows) + 64)
               for name, rows in corpora.items()},
        "online": {name: {"corpus": c, "kw": dict(base, **kw), "rule": rule,
                          "shapes": [sh for sh, n_ in PATH_CASES if n_ == name]}
                   for name, (c, kw, rule, _) in ONLINE.items()},
        "nmf": {name: {"corpus": c, "kw": dict(k=K, max_iterations=SWEEPS,
                                               token_layout=layout),
                       "flat": flat}
                for name, (c, layout, flat) in NMF_CASES.items()},
        "nmf_init": nmf_init,
        "seed": {
            "padded": {"corpus": "even", "nmf": False, "rule": "cpu",
                       "kw": dict(seed_kw, token_layout="padded",
                                  device_resident=True)},
            "packed": {"corpus": "skewed", "nmf": False, "rule": "cpu",
                       "kw": dict(seed_kw, token_layout="packed")},
            "nmf_padded": {"corpus": "even", "nmf": True,
                           "kw": dict(k=K, seed=5, max_iterations=20,
                                      token_layout="padded")},
            "nmf_packed": {"corpus": "skewed", "nmf": True,
                           "kw": dict(k=K, seed=5, max_iterations=20,
                                      token_layout="packed")},
        },
        "ckpt_rows": {"even": (_corpus(40, 300, 17, lambda r: r.integers(
                          5, 40)), 300),
                      "odd": (_corpus(40, 301, 19, lambda r: r.integers(
                          5, 40)), 301)},
        "ckpt_kw": dict(k=K, seed=3, sampling="fixed", batch_size=16,
                        token_layout="padded", checkpoint_interval=2),
        "ckpt_out": {n: str(root / f"written_{n}") for n in ("even", "odd")},
    }


_RUNS: dict = {}
_JAX: dict = {}


def ranks(spec, shape):
    """Every rank's ``suite`` results for ``shape``, spawned once."""
    if shape not in _RUNS:
        _RUNS[shape] = run_grid(worker.suite, *shape, (spec,), device="cpu",
                                timeout=300)
    return _RUNS[shape]


def jax_online(spec, shape, name):
    """JAX's online fit of ``ONLINE[name]`` on a ``shape`` mesh, from the
    spec's lambda: (lam, decisions, picks of iterations 0-3)."""
    key = (shape, name)
    if key not in _JAX:
        corpus, kw, _, backend = ONLINE[name]
        rows = spec["corpora"][corpus]
        d, m = shape
        with pytest.MonkeyPatch.context() as mp:
            if backend:
                mp.setenv("STC_GAMMA_BACKEND", backend)
            else:
                mp.delenv("STC_GAMMA_BACKEND", raising=False)
            opt = JOnlineLDA(JParams(algorithm="online", data_shards=d,
                                     model_shards=m,
                                     **spec["online"][name]["kw"]),
                             mesh=_mesh(shape))
            model = opt.fit(rows, [f"t{i}" for i in range(V)])
        dec = {n_: getattr(opt, n_, None) for n_ in worker.DECISIONS}
        pick = opt.tile_pick if dec["last_layout"] == "tiles_resident" \
            else opt.sample_pick
        _JAX[key] = (np.asarray(model.lam), dec, [pick(i) for i in range(4)])
    return _JAX[key]


# ---- online VB: the five paths against JAX on the same mesh ---------------
@pytest.mark.parametrize("shape,name", PATH_CASES, ids=PATH_IDS)
def test_online_path_matches_jax_on_the_same_mesh(spec, shape, name):
    """Three iterations of each online path on the grid against the JAX
    package's fit on a mesh of the same shape, from one lambda and JAX's
    gamma inits: lambda within rtol 1e-4 on every rank (both packages
    stop per tile, or both run the whole-batch loop)."""
    want, _, _ = jax_online(spec, shape, name)
    for r in ranks(spec, shape):
        got = r["online"][name]
        assert got["step"] == ITERS
        np.testing.assert_allclose(got["lam"], want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,name", PATH_CASES, ids=PATH_IDS)
def test_online_decisions_match_jax(spec, shape, name):
    """The decisions bit for bit against JAX's on the same mesh: path, row
    length, batch size (bsz rounded to the data shards), gamma loop,
    cells, the tile geometry with ``reals_per_shard`` and tiles a shard,
    and the first four iterations' picks (``tile_pick``: [data shards,
    tiles] local to each shard).  On the padded paths the JAX package
    names no gamma loop (it keeps "xla"); the port names its E-step."""
    _, want, want_picks = jax_online(spec, shape, name)
    for r in ranks(spec, shape):
        got = dict(r["online"][name]["decisions"])
        if got["last_layout"] == "padded":
            assert got.pop("last_gamma_backend") == "pallas"
            want = {k_: v_ for k_, v_ in want.items()
                    if k_ != "last_gamma_backend"}
        assert got == want
        for g, w in zip(r["online"][name]["picks"], want_picks):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if name == "tiles_resident":
        assert want_picks[0].shape[0] == shape[0]
        assert len(want["last_tiles"]["reals_per_shard"]) == shape[0]


@pytest.mark.parametrize("name", ["padded", "packed"])
def test_online_grid_fit_from_a_seed_matches_one_device(spec, name):
    """No checkpoint: lambda is one draw at every grid, and each doc's
    inits depend on (seed, step, doc) only, so three iterations with
    ``sampling="fixed"`` and 16 docs a minibatch (8 a data shard: the
    E-step's tiles of 8 are the one-device fit's) on the 2x2 grid agree
    with the one-device fit within rtol 1e-4."""
    c = spec["seed"][name]
    rows = spec["corpora"][c["corpus"]]
    want = OnlineLDA(Params(algorithm="online", **c["kw"]), device="cpu",
                     rule="cpu").fit(rows, [f"t{i}" for i in range(V)])
    for r in ranks(spec, (2, 2)):
        np.testing.assert_allclose(r[f"seed_{name}"]["lam"], want.lam,
                                   rtol=1e-4, atol=1e-6)


# ---- checkpoints ----------------------------------------------------------
def test_online_checkpoint_written_on_the_grid_resumes_on_one_device(
        spec, tmp_path):
    """A train_state.npz the 2x2 grid wrote at step 2 (rank 0 only, lambda
    [k, V]) is read by the JAX package's loader, and the port's 1x1 fit
    resumes it to step 4 as the grid's own resume does, within rtol
    1e-4."""
    grid = ranks(spec, (2, 2))
    rows, v = spec["ckpt_rows"]["even"]
    path = os.path.join(spec["ckpt_out"]["even"], "train_state.npz")
    st = j_load_train_state(path)
    assert st["step"] == 2 and st["lam"].shape == (K, v)
    np.testing.assert_allclose(st["lam"], grid[0]["ckpt_even"]["lam"],
                               rtol=1e-6)
    ckpt = str(tmp_path / "one")
    shutil.copytree(spec["ckpt_out"]["even"], ckpt)
    one = OnlineLDA(Params(algorithm="online", **dict(
        spec["ckpt_kw"], checkpoint_dir=ckpt, checkpoint_interval=100)),
        device="cpu").fit(rows, [f"t{i}" for i in range(v)],
                          max_iterations=4)
    assert one.step == 4
    for r in grid:
        assert r["ckpt_even_resumed"]["step"] == 4
        np.testing.assert_allclose(r["ckpt_even_resumed"]["lam"], one.lam,
                                   rtol=1e-4, atol=1e-6)


def test_online_odd_vocabulary_checkpoint_keeps_v_pad(spec, tmp_path):
    """With V odd the 2x2 grid draws and checkpoints lambda at V_pad =
    V + 1 columns: both packages refuse it at 1x1, and the grid resumes
    it to step 4 with a model of V columns."""
    grid = ranks(spec, (2, 2))
    rows, v = spec["ckpt_rows"]["odd"]
    with np.load(os.path.join(spec["ckpt_out"]["odd"],
                              "train_state.npz")) as z:
        assert z["lam"].shape == (K, v + 1)
    vocab = [f"t{i}" for i in range(v)]
    for who in ("jax", "port"):
        path = str(tmp_path / who)
        shutil.copytree(spec["ckpt_out"]["odd"], path)
        kw = dict(spec["ckpt_kw"], checkpoint_dir=path, max_iterations=4)
        with pytest.raises(ValueError, match="checkpoint lam"):
            if who == "jax":
                JOnlineLDA(JParams(algorithm="online", **kw),
                           mesh=_mesh((1, 1))).fit(rows, vocab)
            else:
                OnlineLDA(Params(algorithm="online", **kw),
                          device="cpu").fit(rows, vocab)
    for r in grid:
        got = r["ckpt_odd_resumed"]
        assert got["step"] == 4 and got["lam"].shape == (K, v)
        assert np.isfinite(got["lam"]).all()


# ---- NMF ---------------------------------------------------------------------
def _jax_nmf(spec, shape, name):
    """The JAX runner of ``NMF_CASES[name]`` on a ``shape`` mesh from the
    spec's W0/H0: (h [k, V], loss)."""
    key = (shape, "nmf", name)
    if key in _JAX:
        return _JAX[key]
    corpus, _, flat = NMF_CASES[name]
    rows = spec["corpora"][corpus]
    w_doc, h0 = spec["nmf_init"][corpus]
    mesh, n = _mesh(shape), len(rows)
    d = shape[0]
    hspec = model_sharding(mesh)
    rowspec = NamedSharding(mesh, P("data", None))
    if name == "padded":
        batch = data_shard_batch(mesh, jbatch(rows))
        w = np.zeros((batch.num_docs, K), np.float32)
        w[:n] = w_doc
        state = NMFTrainState(jax.device_put(w, rowspec),
                              jax.device_put(h0, hspec))
        step = make_nmf_train_step(mesh)
        for _ in range(SWEEPS):
            state = step(state, batch)
        out = (np.asarray(state.h),
               float(j_frobenius_loss(batch, state.w, state.h)))
    else:
        flat_ids = np.concatenate([i for i, _ in rows])
        flat_cts = np.concatenate([c for _, c in rows])
        x2 = float((flat_cts.astype(np.float64) ** 2).sum())
        if flat:
            ids, cts, seg, slot, d_max, _ = JNMF(
                JParams(k=K, data_shards=d, model_shards=shape[1]),
                mesh=mesh)._packed_plan(rows, n)
            w = np.zeros((d * d_max, K), np.float32)
            w[slot] = w_doc
            tok = NamedSharding(mesh, P("data"))
            run = make_nmf_packed_runner(mesh)
        else:
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
            plan = j_plan_corpus_tiles(flat_ids, flat_cts, offsets,
                                       n_shards=d, k=K)
            ids, cts, seg = plan.ids, plan.cts, plan.seg
            w = np.zeros((ids.shape[0] * plan.d, K), np.float32)
            live = plan.doc_ids.reshape(-1) < n
            w[live] = w_doc[plan.doc_ids.reshape(-1)[live]]
            tok = rowspec
            run = make_nmf_packed_runner(mesh, d=plan.d, interpret=True)
        _, h, loss = run(jax.device_put(w, rowspec),
                         jax.device_put(h0, hspec),
                         *(jax.device_put(a, tok) for a in (ids, cts, seg)),
                         x2, SWEEPS)
        out = (np.asarray(h), float(loss))
    _JAX[key] = out
    return out


@pytest.mark.parametrize("name", sorted(NMF_CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_nmf_matches_jax_on_the_same_mesh(spec, shape, name):
    """Five sweeps of the grid fit with W0 and H0 given, against
    ``make_nmf_train_step`` (padded) and ``make_nmf_packed_runner`` (tiles:
    the Pallas kernel in interpret mode; flat: the greedy doc-to-shard
    packing) on the same mesh: H within rtol 1e-4, the loss within 1e-4
    relative, on every rank."""
    want_h, want_loss = _jax_nmf(spec, shape, name)
    layout = {"padded": ("padded", "none"), "tiles": ("packed", "plain_tiles"),
              "flat": ("packed", "flat")}[name]
    for r in ranks(spec, shape):
        h, loss, *got_layout = r["nmf"][name]
        assert tuple(got_layout) == layout
        np.testing.assert_allclose(h, want_h, rtol=1e-4, atol=1e-7)
        assert loss == pytest.approx(want_loss, rel=1e-4)


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_nmf_grid_fit_from_a_seed_matches_one_device(spec, layout):
    """The 2x2 fit from a seed starts from the 1x1 draws: after 20 sweeps
    H within rtol 1e-3 (each entry, floored at 1e-6 of the largest) and
    the loss within 1e-4 relative of the port's one-device fit."""
    c = spec["seed"][f"nmf_{layout}"]
    rows = spec["corpora"][c["corpus"]]
    opt = NMF(Params(**c["kw"]), device="cpu")
    want = opt.fit(rows, [f"t{i}" for i in range(V)])
    floor = 1e-6 * float(np.abs(want.h).max())
    for r in ranks(spec, (2, 2)):
        h, loss, got_layout, _ = r[f"seed_nmf_{layout}"]
        assert got_layout == opt.last_layout == layout
        rel = np.abs(h - want.h) / np.maximum(np.abs(want.h), floor)
        assert rel.max() <= 1e-3
        assert loss == pytest.approx(want.loss, rel=1e-4)
