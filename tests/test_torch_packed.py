"""The port's token-packed tile module held against the JAX package's.

The tile planners are numpy copies and must cut the corpus exactly as the
JAX package does (so both sample the same docs together).  The plain
version of the tile gamma kernel, which the wrapper runs for CPU tensors,
is held against the Pallas kernel in interpret mode on the same numpy
inputs; the CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_text_clustering_tpu.ops import lda_math as jlda
from spark_text_clustering_tpu.ops import pallas_packed as jpacked
from spark_text_clustering_tpu_torch.ops import packed as tpacked


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _corpus(n_docs, v, lens, seed):
    """Flat doc-contiguous ids/cts and doc fences for the given lengths."""
    rng = np.random.default_rng(seed)
    ids = [rng.choice(v, size=int(m), replace=False).astype(np.int32)
           for m in lens]
    cts = [rng.integers(1, 6, size=int(m)).astype(np.float32) for m in lens]
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return np.concatenate(ids), np.concatenate(cts), offsets


def _lens(case, rng):
    if case == "skewed":
        return np.clip(rng.lognormal(2.5, 1.2, 240), 1, 400).astype(int)
    if case == "empty_docs":
        lens = rng.integers(0, 30, 200)
        lens[[0, 7, 8, 199]] = 0
        return lens
    if case == "exactly_tt":
        lens = rng.integers(1, 60, 120)
        lens[[3, 50]] = 512                     # fills a whole 512 tile
        return lens
    return rng.integers(3, 7, 240)              # "shrunk_budget"


_PLAN_CASES = ["skewed", "empty_docs", "exactly_tt", "shrunk_budget"]


@pytest.mark.parametrize("case", _PLAN_CASES)
@pytest.mark.parametrize("n_shards,k", [(1, 5), (4, 20)])
def test_plan_corpus_tiles_matches_jax(case, n_shards, k, monkeypatch):
    """Every array and the geometry are equal element for element.  The
    shrunk budget (the JAX tiles-resident test's 512 KB) clamps d to the
    128-slot floor, with docs so short that the slot cap closes tiles."""
    if case == "shrunk_budget":
        monkeypatch.setattr(jpacked, "_VMEM_TILE_BUDGET", 1 << 19)
        monkeypatch.setattr(tpacked, "_VMEM_TILE_BUDGET", 1 << 19)
    lens = _lens(case, np.random.default_rng(5))
    ids, cts, offsets = _corpus(len(lens), 1000, lens, seed=6)
    want = jpacked.plan_corpus_tiles(ids, cts, offsets, n_shards=n_shards, k=k)
    got = tpacked.plan_corpus_tiles(ids, cts, offsets, n_shards=n_shards, k=k)
    assert got is not None and want is not None
    assert (got.tt, got.d, got.b) == (want.tt, want.d, want.b)
    for name in ("ids", "cts", "seg", "doc_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if case == "shrunk_budget":
        assert got.d == 128 and got.ids.shape[0] >= 2
    if case == "exactly_tt":
        assert got.tt == 512 and ((got.seg < got.d).sum(1) == 512).any()


@pytest.mark.parametrize("tile_tokens,max_docs", [(None, None), (512, 4),
                                                  (1024, None)])
def test_plan_tile_pack_matches_jax(tile_tokens, max_docs):
    """The packer itself, with input pad tokens (cts == 0) to drop."""
    lens = _lens("skewed", np.random.default_rng(9))[:80]
    ids, cts, offsets = _corpus(len(lens), 1000, lens, seed=2)
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    cts[::11] = 0.0
    kw = dict(tile_tokens=tile_tokens, max_docs=max_docs, k=5)
    want = jpacked.plan_tile_pack(ids, cts, seg, len(lens), **kw)
    got = tpacked.plan_tile_pack(ids, cts, seg, len(lens), **kw)
    assert (got.tt, got.d, got.b) == (want.tt, want.d, want.b)
    for name in ("ids", "cts", "seg", "doc_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _tiles_problem(k, seed=0):
    """A plan with empty docs and all-pad tiles (n_shards=4 pads the tile
    axis), eb from a random lambda, random gamma inits."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 90, 70)
    lens[[2, 40, 69]] = 0
    v = 800
    ids, cts, offsets = _corpus(len(lens), v, lens, seed=seed + 1)
    plan = tpacked.plan_corpus_tiles(ids, cts, offsets, n_shards=4, k=k)
    assert (plan.doc_ids[:, 0] == len(lens)).any()          # a pad tile
    lam = rng.gamma(100.0, 0.01, (k, v)).astype(np.float32)
    eb = np.asarray(jnp.exp(jlda.dirichlet_expectation(jnp.asarray(lam))))
    eb_kt = np.ascontiguousarray(eb[:, plan.ids.reshape(-1)])
    g0 = rng.gamma(100.0, 0.01, (k, plan.ids.shape[0] * plan.d))
    alpha = np.full((k,), 1.0 / k, np.float32)
    return plan, eb_kt, g0.astype(np.float32), alpha


@pytest.mark.parametrize("k", [2, 5, 20])
def test_gamma_fixed_point_tiles_matches_pallas(k):
    """Normalized gamma within 5e-3 everywhere (the Pallas kernel's own
    bound against the XLA loop) and a median per-slot difference under
    1e-5: same algorithm and per-tile stop rule, float32 rounding apart.
    Pad slots end at alpha exactly, as in JAX."""
    plan, eb_kt, g0, alpha = _tiles_problem(k)
    want = np.asarray(jpacked.gamma_fixed_point_tiles(
        jnp.asarray(eb_kt), jnp.asarray(plan.cts), jnp.asarray(plan.seg),
        jnp.asarray(alpha), jnp.asarray(g0), d=plan.d, interpret=True))
    got = tpacked.gamma_fixed_point_tiles(
        _t(eb_kt), _t(plan.cts), _t(plan.seg), _t(alpha), _t(g0), plan.d)
    assert got.shape == want.shape
    got = got.numpy()
    norm = lambda g: g / g.sum(0, keepdims=True)          # noqa: E731
    diff = np.abs(norm(got) - norm(want)).max(axis=0)
    assert diff.max() <= 5e-3
    assert np.median(diff) <= 1e-5
    pad = plan.doc_ids.reshape(-1) == plan.b
    np.testing.assert_array_equal(got[:, pad], np.broadcast_to(
        alpha[:, None], (k, int(pad.sum()))))


def test_gamma_fixed_point_tiles_stops_per_tile():
    """A tile stops at its own worst slot: with max_inner=1 every tile
    runs once; iteration counts differ across tiles at the default."""
    plan, eb_kt, g0, alpha = _tiles_problem(5, seed=3)
    args = (_t(eb_kt), _t(plan.cts), _t(plan.seg), _t(alpha), _t(g0), plan.d)
    _, iters1 = tpacked.gamma_fixed_point_tiles_plain(
        *args, max_inner=1, with_iters=True)
    assert (iters1 == 1).all()
    _, iters = tpacked.gamma_fixed_point_tiles_plain(*args, with_iters=True)
    assert iters.min() < iters.max() and int(iters.min()) >= 1


def test_tile_doc_reorders_match_jax():
    plan, _, g0, _ = _tiles_problem(5, seed=4)
    b = plan.b
    want = np.asarray(jpacked.tile_gamma_to_docs(
        jnp.asarray(g0), jnp.asarray(plan.doc_ids), b))
    got = tpacked.tile_gamma_to_docs(_t(g0), _t(plan.doc_ids), b).numpy()
    np.testing.assert_array_equal(got, want)
    docs = np.random.default_rng(1).random((b, 5)).astype(np.float32)
    want = np.asarray(jpacked.docs_gamma_to_tiles(
        jnp.asarray(docs), jnp.asarray(plan.doc_ids)))
    got = tpacked.docs_gamma_to_tiles(_t(docs), _t(plan.doc_ids)).numpy()
    np.testing.assert_array_equal(got, want)
