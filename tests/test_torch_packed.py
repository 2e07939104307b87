"""The port's token-packed tile module held against the JAX package's.

The tile planners are numpy copies and must cut the corpus exactly as the
JAX package does (so both sample the same docs together).  The plain
version of the tile gamma kernel, which the wrapper runs for CPU tensors,
is held against the Pallas kernel in interpret mode on the same numpy
inputs; the CUDA kernel is held against the plain version on the card by
``chip_smoke.py``, and here its own source, compiled by g++ against a
small CPU stand-in for the CUDA runtime (threads, barriers, warp
shuffles), is held against the plain version at small sizes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_text_clustering_tpu.ops import lda_math as jlda
from spark_text_clustering_tpu.ops import pallas_packed as jpacked
from spark_text_clustering_tpu_torch.ops import packed as tpacked

from cuda_shim import build_on_cpu


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


def _tiles_problem(k, seed=0, long_doc=False):
    """A plan with empty docs and all-pad tiles (n_shards=4 pads the tile
    axis), eb from a random lambda, random gamma inits.  ``long_doc``
    adds a 512-token doc, which fills a tile of its own."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 90, 70)
    lens[[2, 40, 69]] = 0
    if long_doc:
        lens[50] = 512
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


@pytest.mark.parametrize("k,long_doc", [
    pytest.param(2, False, id="2"), pytest.param(5, False, id="5"),
    pytest.param(20, False, id="20"), pytest.param(33, False, id="33"),
    pytest.param(20, True, id="long_doc"),
])
def test_gamma_fixed_point_tiles_matches_pallas(k, long_doc):
    """Normalized gamma within 5e-3 everywhere (the Pallas kernel's own
    bound against the XLA loop) and a median per-slot difference under
    1e-5: same algorithm and per-tile stop rule, float32 rounding apart.
    Pad slots end at alpha exactly, as in JAX.  k=33 is past one topic a
    lane of the CUDA kernel; the long doc fills a 512-token tile."""
    plan, eb_kt, g0, alpha = _tiles_problem(k, long_doc=long_doc)
    if long_doc:
        assert ((plan.seg < plan.d).sum(1) == 512).any()
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


def _walk(seg_row, d, warps):
    """The kernel's split of a tile, by a direct numpy walk: live tokens
    in ranges of R, cut where the range or the doc slot changes."""
    n_tok = int((seg_row < d).sum())
    r = max(32, -(-(-(-n_tok // warps)) // 32) * 32)
    warp = np.arange(n_tok) // r
    slot = seg_row[:n_tok]
    cut = np.flatnonzero((np.diff(warp) != 0) | (np.diff(slot) != 0)) + 1
    t0 = np.r_[0, cut] if n_tok else np.zeros(0, int)
    t1 = np.r_[cut, n_tok] if n_tok else np.zeros(0, int)
    return r, np.stack([warp[t0], slot[t0], t0, t1], 1) if n_tok else (
        np.zeros((0, 4), int))


@pytest.mark.parametrize("case", ["c_shape", "one_doc_512"])
def test_tile_work_matches_a_direct_walk(case):
    """The tile kernel's launch geometry: 16 warps at tt=512, each taking
    at most 32 live tokens; the pieces (one per doc run inside a warp's
    range) equal a direct walk of the plan, and their rows slot + warp in
    the piece table are unique.  At
    C's shape (20NG-like lengths, k=20: tt=512, d=128) and on a tile that
    holds one 512-token doc (16 pieces of 32 tokens, one slot)."""
    rng = np.random.default_rng(8)
    lens = np.minimum(np.maximum(4, rng.lognormal(4.4, 0.8, 600)), 400)
    lens = lens.astype(int)
    if case == "one_doc_512":
        lens[5] = 512
    ids, cts, offsets = _corpus(len(lens), 2000, lens, seed=9)
    plan = tpacked.plan_corpus_tiles(ids, cts, offsets, k=20)
    assert (plan.tt, plan.d) == (512, 128)
    warps = tpacked.tile_warps(plan.tt)
    assert warps == 16
    rows = plan.seg
    if case == "one_doc_512":
        rows = plan.seg[((plan.seg < plan.d).sum(1) == 512)
                        & (plan.seg == plan.seg[:, :1]).all(1)]
        assert len(rows) == 1 and (rows[0] == 0).all()
    for row in rows:
        work = tpacked.tile_work(row, plan.d, warps)
        r, pieces = _walk(row, plan.d, warps)
        assert work.tokens_per_warp == r == 32
        assert work.n_tok == int((row < plan.d).sum())
        assert work.n_act == (int(row[work.n_tok - 1]) + 1 if work.n_tok else 0)
        np.testing.assert_array_equal(work.pieces, pieces)
        rows_used = work.pieces[:, 0] + work.pieces[:, 1]
        assert len(np.unique(rows_used)) == len(rows_used)
        assert rows_used.max() < plan.d + warps
        per_warp = np.bincount(work.pieces[:, 0],
                               weights=work.pieces[:, 3] - work.pieces[:, 2])
        assert per_warp.max() <= 32
    if case == "one_doc_512":
        np.testing.assert_array_equal(work.pieces[:, 0], np.arange(16))
        assert (work.pieces[:, 1] == 0).all()
        assert ((work.pieces[:, 3] - work.pieces[:, 2]) == 32).all()


@pytest.mark.parametrize("tt,warps", [(8, 1), (64, 2), (512, 16),
                                      (1024, 16)])
def test_tile_warps(tt, warps):
    assert tpacked.tile_warps(tt) == warps


@pytest.fixture(scope="module")
def tile_kernel_on_cpu(tmp_path_factory):
    """csrc/packed.cu itself, compiled by g++ against the CPU stand-in for
    the CUDA runtime (``cuda_shim``)."""
    return build_on_cpu("packed", "tiles_kernel", 2,
                        tmp_path_factory.mktemp("tile_kernel"))


# case: (k, max_inner, warps); a CTA of 4 warps gives each warp 128 live
# tokens (four stripes of 32), 16 warps the 32 of the card's main path
_CPU_THREAD_CASES = {
    "k20": (20, 12, 4), "k33": (33, 12, 4), "long_doc": (20, 6, 16),
    "all_pad": (20, 100, 16), "max_inner_0": (20, 0, 4),
    "max_inner_1": (20, 1, 4), "global_state": (64, 12, 4),
}


@pytest.mark.parametrize("case", list(_CPU_THREAD_CASES))
def test_tile_kernel_source_on_cpu_threads(tile_kernel_on_cpu, case):
    """The CUDA kernel's own source, run on CPU threads, against the plain
    version: normalized gamma within 5e-3, a bit-for-bit repeat, pad slots
    exactly alpha (gamma0 as it is at max_inner=0).  Covers the lane loop
    past 32 topics, a 512-token doc over 16 warps, a live tile beside an
    all-pad one (each stops on its own), and the state kept in the scratch
    buffer (k=64 does not fit shared memory).  The threads meet at real
    barriers, ~0.03 s an iteration at 4 warps, so iterations are capped."""
    lib = tile_kernel_on_cpu
    k, max_inner, warps = _CPU_THREAD_CASES[case]
    tol = 1e-3
    plan, eb_kt, g0, alpha = _tiles_problem(k, long_doc=case == "long_doc")
    n_tiles, tt = plan.cts.shape
    live = (plan.seg < plan.d).sum(1)
    pad_tiles = np.flatnonzero(plan.doc_ids[:, 0] == plan.b)
    if case == "long_doc":
        sel = np.flatnonzero(live == 512)[:1]
    elif case == "all_pad":
        sel = pad_tiles[:1]
    elif case == "k20":
        sel = np.r_[pad_tiles[0] - 1, pad_tiles[0]]
    else:
        sel = np.arange(1)
    d = plan.d
    eb = eb_kt.reshape(k, n_tiles, tt)[:, sel].reshape(k, -1).copy()
    cts, seg = plan.cts[sel].copy(), plan.seg[sel].copy()
    g = g0.reshape(k, n_tiles, d)[:, sel].reshape(k, -1).copy()
    per_tile = lib.stc_tiles_scratch_floats(k, d, tt, warps)
    assert lib.stc_tiles_smem_bytes(k, d, tt, warps) > 0
    assert (per_tile > 0) == (case == "global_state")

    def run():
        out = np.full((k, len(sel) * d), np.nan, np.float32)
        scratch = np.full(max(1, len(sel) * per_tile), np.nan, np.float32)
        err = lib.stc_gamma_fixed_point_tiles(
            eb.ctypes.data, cts.ctypes.data, seg.ctypes.data,
            alpha.ctypes.data, g.ctypes.data, len(sel), k, tt, d, max_inner,
            warps, tol, out.ctypes.data,
            scratch.ctypes.data if per_tile else None, None)
        assert err == 0
        return out

    got = run()
    np.testing.assert_array_equal(run(), got)
    want, iters = tpacked.gamma_fixed_point_tiles_plain(
        _t(eb), _t(cts), _t(seg), _t(alpha), _t(g), d, max_inner, tol,
        with_iters=True)
    if case == "k20":
        assert iters.tolist() == [max_inner, 2]
    want = want.numpy()
    norm = lambda a: a / a.sum(0, keepdims=True)          # noqa: E731
    assert np.abs(norm(got) - norm(want)).max() <= 5e-3
    pad = plan.doc_ids[sel].reshape(-1) == plan.b
    if max_inner == 0:
        np.testing.assert_array_equal(got, g)
    else:
        np.testing.assert_array_equal(got[:, pad], np.broadcast_to(
            alpha[:, None], (k, int(pad.sum()))))
