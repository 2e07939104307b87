"""The port's (data, model) process grid held against the JAX package's
mesh, on the CPU.

The port's ranks are processes: ``parallel.run_grid`` spawns each grid
shape once, (1, 2), (2, 1) and (2, 2), over gloo with a ``file://``
rendezvous, one torch thread a rank, and every rank runs
``torch_grid_worker.suite``.  The JAX package runs the same fits on a
mesh of as many of the 8 virtual CPU devices, in this process, on its
XLA sweep (the default off the TPU: no scatter plan, no kernel), so the
two agree to summation order.  EM fits resume from one ``em_state.npz``
written by the JAX package.  Sharded evaluation runs JAX's XLA gamma
loop (whole-batch convergence) against the port's E-step with its
per-tile stop, hence the 5e-3 on distributions.
"""

from __future__ import annotations

import os
import shutil

import jax
import numpy as np
import pytest

from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.em_lda import EMLDA as JEMLDA
from spark_text_clustering_tpu.models.persistence import (
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.models.sharded_eval import (
    make_sharded_em_log_likelihood as j_em_loglik,
    make_sharded_top_terms as j_top_terms,
)
from spark_text_clustering_tpu.ops.sparse import batch_from_rows as jbatch
from spark_text_clustering_tpu.ops.tfidf import (
    make_doc_freq_sharded as j_df_sharded,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu.parallel.collectives import data_shard_batch
from spark_text_clustering_tpu.parallel.mesh import model_sharding
from spark_text_clustering_tpu.pipeline import IDF as JIDF
from spark_text_clustering_tpu_torch import EMLDA, IDF, Params
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.parallel import (
    initialize_distributed,
    make_grid,
    run_grid,
)

import torch_grid_worker

K, V, ITERS = 4, 400, 5
SHAPES = [(1, 2), (2, 1), (2, 2)]
IDS = ["1x2", "2x1", "2x2"]


def _corpus(n_docs, v, lo, hi, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_docs):
        nnz = int(rng.integers(lo, hi))
        ids = np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, (rng.random(nnz) * 3 + 0.2).astype(np.float32)))
    return rows


def _start(rows, v, seed):
    """A random soft assignment (n_wk [K, V], n_dk [n, K])."""
    rng = np.random.default_rng(seed)
    n_wk = np.zeros((K, v), np.float32)
    n_dk = np.zeros((len(rows), K), np.float32)
    for d, (ids, w) in enumerate(rows):
        phi = rng.exponential(size=(len(ids), K)).astype(np.float32)
        wphi = w[:, None] * phi / phi.sum(1, keepdims=True)
        n_dk[d] = wphi.sum(0)
        np.add.at(n_wk.T, ids, wphi)
    return n_wk, n_dk


def _mesh(shape):
    d, m = shape
    return make_mesh(d, m, devices=jax.devices("cpu")[:d * m])


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Every input the ranks take: corpora, the JAX-written starts, the
    checkpoint dirs the 2x2 grid writes, the evaluation model."""
    root = tmp_path_factory.mktemp("grid")
    fused = _corpus(40, V, 4, 60, seed=3)          # d <= 512 a shard
    two_stage = _corpus(1100, V, 3, 12, seed=5)    # d > 512 a shard
    ckpt = {}
    for name, rows in (("fused", fused), ("two_stage", two_stage)):
        path = str(root / f"start_{name}")
        j_save_train_state(os.path.join(path, "em_state.npz"), 0,
                           **dict(zip(("n_wk", "n_dk"),
                                      _start(rows, V, seed=7))))
        ckpt[name] = path
    ckpt["padded"] = ckpt["fused"]
    rng = np.random.default_rng(11)
    ev_rows = _corpus(37, 303, 1, 90, seed=13)
    n_wk = rng.gamma(1.0, 5.0, (K, 303)).astype(np.float32)
    n_wk[:, ::17] = 0.0                             # EM's exact zeros
    return {
        "k": K, "v": V, "iters": ITERS,
        "rows_fused": fused,
        "fits": {"fused": (fused, "packed"),
                 "two_stage": (two_stage, "packed"),
                 "padded": (fused, "padded")},
        "ckpt": ckpt,
        "ckpt_rows": {"even": (_corpus(30, 300, 3, 40, seed=17), 300),
                      "odd": (_corpus(30, 301, 3, 40, seed=19), 301)},
        "ckpt_out": {n: str(root / f"written_{n}") for n in ("even", "odd")},
        "coll": {
            "table": rng.gamma(1.0, 1.0, (K, 404)).astype(np.float32),
            "ids": rng.integers(0, 403, (6, 16)).astype(np.int32),
            "vals": rng.random((6, 16, K)).astype(np.float32),
            "v": 403,
        },
        "eval": {
            "lam": rng.gamma(100.0, 0.01, (K, 303)).astype(np.float32)
            + rng.gamma(0.3, 3.0, (K, 303)).astype(np.float32),
            "alpha": 0.25, "eta": 0.25,
            "n_wk": n_wk, "em_alpha": 50.0 / K + 1.0, "em_eta": 1.1,
            "n_dk": rng.gamma(1.0, 20.0, (37, K)).astype(np.float32),
            "rows": ev_rows,
        },
    }


_RUNS: dict = {}
_JAX: dict = {}


def ranks(spec, shape):
    """Every rank's ``suite`` results for ``shape``, spawned once."""
    if shape not in _RUNS:
        _RUNS[shape] = run_grid(torch_grid_worker.suite, *shape, (spec,),
                                device="cpu", timeout=300)
    return _RUNS[shape]


def jax_fit(spec, shape, name, ckpt=None, iters=ITERS, rows=None, v=V):
    """JAX's EM fit of ``spec["fits"][name]`` on a ``shape`` mesh:
    (lam, avg logLik, step)."""
    key = (shape, name, ckpt, iters)
    if key not in _JAX:
        rows_f, layout = spec["fits"].get(name, (rows, "packed"))
        rows_f = rows if rows is not None else rows_f
        d, m = shape
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("STC_GAMMA_BACKEND", raising=False)
            opt = JEMLDA(JParams(
                k=K, max_iterations=iters, token_layout=layout,
                checkpoint_dir=ckpt or spec["ckpt"][name],
                checkpoint_interval=100, data_shards=d, model_shards=m),
                mesh=_mesh(shape))
            model = opt.fit(rows_f, [f"t{i}" for i in range(v)])
        assert opt.last_scatter_backend in ("xla", "none")
        _JAX[key] = (np.asarray(model.lam),
                     opt.last_log_likelihood / len(rows_f), model.step)
    return _JAX[key]


# ---- collectives --------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_collectives_match_full_table(spec, shape):
    """Each collective on every rank against the full-table reference:
    sums over the axes, gathers of term rows in the three layouts, the
    sharded scatter after psum_data, fetches along both axes, the
    handoff, and the data shards' row blocks."""
    c = spec["coll"]
    table, ids, vals = c["table"], c["ids"], c["vals"]
    d, m = shape
    want_scatter = np.zeros_like(table)
    np.add.at(want_scatter.T, ids.reshape(-1), vals.reshape(-1, K) * d)
    rows = spec["rows_fused"]
    per = -(-len(rows) // d)
    want_w = jbatch(rows, row_len=64).token_weights
    for r in ranks(spec, shape):
        got = r["coll"]
        np.testing.assert_array_equal(got["psum_data"], np.full(3, d))
        np.testing.assert_array_equal(got["psum_model"], np.full(3, m))
        np.testing.assert_allclose(got["row_sum"], table.sum(1), rtol=1e-6)
        np.testing.assert_array_equal(got["gather"], table.T[ids])
        np.testing.assert_array_equal(got["gather_bkl"],
                                      table.T[ids].transpose(0, 2, 1))
        np.testing.assert_array_equal(got["gather_kbl"], table[:, ids])
        for key in ("scatter", "scatter_bkl"):
            np.testing.assert_allclose(got[key], want_scatter, rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(got["fetch_model"], table)
        np.testing.assert_array_equal(got["handoff"], table[:, :c["v"]])
        lo, hi, block, live = got["block"]
        dd = r["coords"][0]
        assert (lo, hi, block) == (min(len(rows), dd * per),
                                   min(len(rows), dd * per + per), per)
        assert live == hi - lo
        np.testing.assert_array_equal(got["fetch_data"][:len(rows)],
                                      np.asarray(want_w))
        assert not got["fetch_data"][len(rows):].any()


# ---- IDF ----------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_df_and_idf_are_exact(spec, shape):
    """The sharded df of one batch equals JAX's ``make_doc_freq_sharded``
    on the same mesh shape bit for bit, and ``IDF(grid=)`` gives the
    port's one-device idf bit for bit, on every rank, and JAX's
    ``IDF(mesh=)`` within the one-device test's rtol 1e-6 (the two
    libraries' log differ by an ulp)."""
    rows = spec["rows_fused"]
    mesh = _mesh(shape)
    want_df = np.asarray(j_df_sharded(mesh, V)(
        data_shard_batch(mesh, jbatch(rows, row_len=64))))
    ds = {"rows": rows, "vocab": [f"t{i}" for i in range(V)]}
    want_idf = np.asarray(JIDF(mesh=mesh).fit(ds).idf)
    one_device = IDF(device="cpu").fit(ds).idf
    for r in ranks(spec, shape):
        np.testing.assert_array_equal(r["df"], want_df)
        np.testing.assert_array_equal(r["idf"], one_device)
        np.testing.assert_allclose(r["idf"], want_idf, rtol=1e-6)


# ---- EM on both layouts ------------------------------------------------
@pytest.mark.parametrize("name,sweep", [("fused", "fused"),
                                        ("two_stage", "two_stage"),
                                        ("padded", "padded")])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_em_fit_matches_jax_on_the_same_mesh(spec, shape, name, sweep):
    """From one JAX-written em_state.npz, 5 sweeps on the grid against
    JAX's fit on a mesh of the same shape: lam within rtol 1e-4, avg
    logLik within 1e-4 relative, on every rank; the port takes the sweep
    the doc axis calls for (fused at <= 512 docs a data shard)."""
    want_lam, want_ll, want_step = jax_fit(spec, shape, name)
    for r in ranks(spec, shape):
        lam, avg, last_sweep, step = r["fits"][name]
        assert last_sweep == sweep and step == want_step == ITERS
        np.testing.assert_allclose(lam, want_lam, rtol=1e-4, atol=1e-4)
        assert avg == pytest.approx(want_ll, rel=1e-4)


@pytest.mark.parametrize("layout", ["packed", "padded"])
def test_grid_fit_from_a_seed_matches_one_device(spec, layout):
    """No checkpoint: the 2x2 fit starts from the 1x1 fit's counts from
    the same seed, so after 5 sweeps lam agrees within rtol 1e-4."""
    rows = spec["rows_fused"]
    opt = EMLDA(Params(k=K, max_iterations=ITERS, seed=5,
                       token_layout=layout), device="cpu")
    want = opt.fit(rows, [f"t{i}" for i in range(V)])
    for r in ranks(spec, (2, 2)):
        lam, avg, _, _ = r[f"seed_{layout}"]
        np.testing.assert_allclose(lam, want.lam, rtol=1e-4, atol=1e-4)
        assert avg == pytest.approx(opt.last_log_likelihood / len(rows),
                                    rel=1e-4)


# ---- checkpoints --------------------------------------------------------
def _resume_1x1(spec, name, root):
    """JAX's and the port's 1x1 fits to step 6 from copies of the
    checkpoint the 2x2 grid wrote at step 4."""
    rows, v = spec["ckpt_rows"][name]
    out = {}
    for who in ("jax", "port"):
        path = str(root / f"{name}_{who}")
        shutil.copytree(spec["ckpt_out"][name], path)
        if who == "jax":
            out[who] = jax_fit(spec, (1, 1), name, ckpt=path, iters=6,
                               rows=rows, v=v)
        else:
            opt = EMLDA(Params(k=K, max_iterations=6, seed=3,
                               token_layout="packed", checkpoint_dir=path,
                               checkpoint_interval=100), device="cpu")
            model = opt.fit(rows, [f"t{i}" for i in range(v)])
            out[who] = (model.lam, opt.last_log_likelihood / len(rows),
                        model.step)
    return out


def test_checkpoint_written_on_the_grid_resumes_on_one_device(
        spec, tmp_path):
    """An em_state.npz the 2x2 grid wrote (coordinator only, n_wk
    [k, V_pad] with V even, n_dk in corpus order) resumes at 1x1 in both
    packages: JAX and the port agree, and agree with the grid's own
    resume, within rtol 1e-4."""
    grid = ranks(spec, (2, 2))
    from spark_text_clustering_tpu_torch.models.persistence import (
        load_train_state,
    )

    st = load_train_state(os.path.join(spec["ckpt_out"]["even"],
                                       "em_state.npz"))
    assert st["step"] == 4 and st["n_wk"].shape == (K, 300)
    assert st["n_dk"].shape == (30, K)
    out = _resume_1x1(spec, "even", tmp_path)
    assert out["jax"][2] == out["port"][2] == 6
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-4,
                               atol=1e-4)
    for r in grid:
        lam, avg, _, step = r["ckpt_even_resumed"]
        assert step == 6
        np.testing.assert_allclose(lam, out["port"][0], rtol=1e-4, atol=1e-4)
        assert avg == pytest.approx(out["jax"][1], rel=1e-4)


def test_odd_vocabulary_checkpoint_keeps_v_pad(spec, tmp_path):
    """With V odd the 2x2 grid's checkpoint holds V_pad = V + 1 columns:
    both packages refuse it at 1x1 (a different V_pad), and JAX's 2x2
    mesh resumes it as the port's 2x2 grid does, within rtol 1e-4."""
    grid = ranks(spec, (2, 2))
    rows, v = spec["ckpt_rows"]["odd"]
    with np.load(os.path.join(spec["ckpt_out"]["odd"], "em_state.npz")) as z:
        assert z["n_wk"].shape == (K, v + 1)
        assert not z["n_wk"][:, v:].any()
    for who in ("jax", "port"):
        path = str(tmp_path / who)
        shutil.copytree(spec["ckpt_out"]["odd"], path)
        with pytest.raises(ValueError, match="do not match this run"):
            if who == "jax":
                jax_fit(spec, (1, 1), "odd", ckpt=path, iters=6, rows=rows,
                        v=v)
            else:
                EMLDA(Params(k=K, max_iterations=6, checkpoint_dir=path,
                             token_layout="packed"),
                      device="cpu").fit(rows, [f"t{i}" for i in range(v)])
    path = str(tmp_path / "jax_2x2")
    shutil.copytree(spec["ckpt_out"]["odd"], path)
    want_lam, want_ll, _ = jax_fit(spec, (2, 2), "odd", ckpt=path, iters=6,
                                   rows=rows, v=v)
    for r in grid:
        lam, avg, _, step = r["ckpt_odd_resumed"]
        assert step == 6 and lam.shape == (K, v)
        np.testing.assert_allclose(lam, want_lam, rtol=1e-4, atol=1e-4)
        assert avg == pytest.approx(want_ll, rel=1e-4)


# ---- sharded evaluation --------------------------------------------------
def _jax_models(spec):
    e = spec["eval"]
    vocab = [f"t{i}" for i in range(e["lam"].shape[1])]
    online = JLDAModel(lam=e["lam"], vocab=vocab,
                       alpha=np.full(K, e["alpha"], np.float32),
                       eta=e["eta"], algorithm="online")
    em = JLDAModel(lam=e["n_wk"], vocab=vocab,
                   alpha=np.full(K, e["em_alpha"], np.float32),
                   eta=e["em_eta"], algorithm="em")
    return online, em


def test_sharded_scoring_matches_jax(spec):
    """``topic_distribution(grid=)`` against JAX's on a 2x2 mesh: within
    5e-3 on every rank; per-doc convergence on a grid is refused."""
    online, _ = _jax_models(spec)
    want = np.asarray(online.topic_distribution(spec["eval"]["rows"],
                                                mesh=_mesh((2, 2))))
    for r in ranks(spec, (2, 2)):
        assert r["dist"].shape == want.shape
        np.testing.assert_allclose(r["dist"], want, atol=5e-3)
        assert np.allclose(r["dist"].sum(1), 1.0, atol=1e-5)
        assert "per_doc" in r["per_doc_error"]


@pytest.mark.parametrize("what", ["bound", "perplexity", "em_bound"])
def test_sharded_bounds_match_jax(spec, what):
    """The variational bound, log-perplexity and an EM model's bound (at
    N_wk + eta) on the 2x2 grid against JAX's on a 2x2 mesh: 1e-4
    relative."""
    online, em = _jax_models(spec)
    rows, mesh = spec["eval"]["rows"], _mesh((2, 2))
    want = {"bound": lambda: online.log_likelihood(rows, mesh=mesh),
            "perplexity": lambda: online.log_perplexity(rows, mesh=mesh),
            "em_bound": lambda: em.log_likelihood(rows, mesh=mesh)}[what]()
    for r in ranks(spec, (2, 2)):
        assert r[what] == pytest.approx(float(want), rel=1e-4)


def test_sharded_em_log_likelihood_matches_jax(spec):
    """``make_sharded_em_log_likelihood`` on the 2x2 grid against JAX's on
    a 2x2 mesh, on the same N_wk (exact zeros included), N_dk and batch:
    1e-4 relative."""
    e = spec["eval"]
    mesh = _mesh((2, 2))
    batch = data_shard_batch(mesh, jbatch(e["rows"]))
    n_dk = np.zeros((batch.num_docs, K), np.float32)
    n_dk[:len(e["rows"])] = e["n_dk"]
    from jax.sharding import NamedSharding, PartitionSpec as P

    v_pad = 304
    n_wk = np.pad(e["n_wk"], ((0, 0), (0, v_pad - 303)))
    want = j_em_loglik(mesh, alpha=e["em_alpha"], eta=e["em_eta"],
                       vocab_size=303)(
        jax.device_put(n_wk, model_sharding(mesh)),
        jax.device_put(n_dk, NamedSharding(mesh, P("data", None))), batch)
    for r in ranks(spec, (2, 2)):
        assert r["em_loglik"] == pytest.approx(float(want), rel=1e-4)


def test_sharded_top_terms_match_jax(spec):
    """Each shard's top-n candidates (global ids, values, true totals) on
    the 2x2 grid equal JAX's ``make_sharded_top_terms`` on a 2x2 mesh,
    and ``describe_topics(grid=)`` ranks the terms the host path does."""
    e = spec["eval"]
    mesh = _mesh((2, 2))
    lam = np.pad(e["lam"], ((0, 0), (0, 1)))
    ids, vals, totals = (np.asarray(a) for a in j_top_terms(mesh, 303, 6)(
        jax.device_put(lam, model_sharding(mesh))))
    want_desc = lda_model_from_numpy(
        e["lam"], e["alpha"], e["eta"], [f"t{i}" for i in range(303)],
        algorithm="online", device="cpu").describe_topics(6)
    for r in ranks(spec, (2, 2)):
        got_ids, got_vals, got_totals = r["top_terms"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_vals, vals, rtol=1e-6)
        np.testing.assert_allclose(got_totals, totals, rtol=1e-5)
        for got, want in zip(r["describe"], want_desc):
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([w for _, w in got],
                                       [w for _, w in want], rtol=1e-5)


# ---- the grid itself ------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_rank_has_its_place(spec, shape):
    """Rank r sits at (r // model_shards, r % model_shards), each in its
    own process."""
    d, m = shape
    got = ranks(spec, shape)
    assert [r["rank"] for r in got] == list(range(d * m))
    assert [r["coords"] for r in got] == [(i // m, i % m)
                                          for i in range(d * m)]
    assert len({r["pid"] for r in got} | {os.getpid()}) == d * m + 1


def test_grid_needs_its_ranks_and_partial_arguments_raise():
    """Without a started world only a 1x1 grid exists; nccl on the CPU and
    partial bring-up arguments raise, naming what to pass."""
    grid = make_grid(1, 1, device="cpu")
    assert (grid.size, grid.rank, grid.data_group) == (1, 0, None)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_grid(2, 2, device="cpu")
    with pytest.raises(ValueError, match="require coordinator"):
        initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="requires num_processes"):
        initialize_distributed("localhost:1", None, 0)
    with pytest.raises(ValueError, match="backend='gloo'"):
        run_grid(torch_grid_worker.suite, 2, 1, (), backend="nccl",
                 device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        EMLDA(Params(k=K, data_shards=2), device="cpu")


_FAKE_NVCC = """#!{python}
import subprocess, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(1.0)
subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", {stub!r}, "-o", out],
               check=True)
"""

_LOADER = """
import sys
from pathlib import Path
from spark_text_clustering_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._nvcc = lambda: sys.argv[2]
print(_build.load_library("estep").stc_estep_max_k())
"""


def test_ranks_loading_a_kernel_at_once_build_it_once(tmp_path):
    """Two processes that load a kernel library at once, as the ranks of a
    grid do, build it once under the build directory's lock and both load
    it; no temporary file is left.  A stand-in for nvcc (g++ on a stub of
    the library's C interface) records each build."""
    import subprocess
    import sys

    if shutil.which("g++") is None:
        pytest.skip("no g++ for the stand-in compiler")
    stub, calls = tmp_path / "stub.c", tmp_path / "calls"
    stub.write_text("int stc_gamma_fixed_point_bkl(void) { return 0; }\n"
                    "int stc_estep_max_k(void) { return 64; }\n"
                    "int stc_estep_max_tile_b(void) { return 8; }\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable,
                                      calls=str(calls), stub=str(stub)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = {**os.environ,
           "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOADER, str(build), str(nvcc)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["64", "64"]
    assert len(calls.read_text().splitlines()) == 1
    names = sorted(os.listdir(build))
    assert len(names) == 2 and names[0] == ".build.lock"
    assert names[1].startswith("estep_") and names[1].endswith(".so")


def test_config_i_bounds_the_grid_by_the_largest_pairwise_spread():
    """``chip_smoke``'s config I bound (fault B1): the spread of five 1x1
    fits is the largest distance of a later fit from an earlier one over
    all ten pairs (relative to max(|earlier|, 1)), and the bound is twice
    it where that passes 1e-3."""
    import chip_smoke

    base = np.array([10.0, 2.0, 0.5])
    lams = [base, base.copy(), base + [0.1, 0, 0], base + [0, 0.004, 0],
            base + [0, 0, 0.003]]
    spread, pairs = chip_smoke.lam_spread(lams)
    want = {"0-1": 0.0, "0-2": 0.01, "0-3": 0.002, "0-4": 0.003,
            "1-2": 0.01, "1-3": 0.002, "1-4": 0.003,
            "2-3": 0.1 / 10.1, "2-4": 0.1 / 10.1, "3-4": 0.003}
    assert sorted(pairs) == sorted(want)
    for key, d in want.items():
        assert pairs[key] == pytest.approx(d, rel=1e-9, abs=1e-15), key
    assert spread == pytest.approx(0.01, rel=1e-9)
    assert chip_smoke.grid_lam_bound(spread) == pytest.approx(0.02)
    small, _ = chip_smoke.lam_spread([base, base + [0, 0, 1e-4]] * 2 + [base])
    assert small == pytest.approx(1e-4)
    assert chip_smoke.grid_lam_bound(small) == 1e-3
