"""The port's kernel modules held against the JAX package's Pallas kernels.

Each kernel of the port (``spark_text_clustering_tpu_torch.ops``) has a
plain PyTorch version that its wrapper runs for CPU tensors; here it runs
on the same numpy inputs as the Pallas kernel in interpret mode.  The
CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_text_clustering_tpu.ops import lda_math as jlda
from spark_text_clustering_tpu.ops import pallas_emscatter as jscatter
from spark_text_clustering_tpu.ops import pallas_emsweep as jsweep
from spark_text_clustering_tpu.ops import pallas_estep as jestep
from spark_text_clustering_tpu_torch.ops import _build
from spark_text_clustering_tpu_torch.ops import emscatter as tscatter
from spark_text_clustering_tpu_torch.ops import emsweep as tsweep
from spark_text_clustering_tpu_torch.ops import estep as testep
from spark_text_clustering_tpu_torch.ops import lda_math as tlda
from spark_text_clustering_tpu_torch.ops import nmf as tnmf
from spark_text_clustering_tpu_torch.ops import packed as tpacked

from cuda_shim import build_on_cpu

ALPHA, ETA = 11.0, 1.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _norm(g):
    g = np.asarray(g, np.float64)
    return g / g.sum(axis=1, keepdims=True)


# ---- digamma -----------------------------------------------------------
def test_digamma_approx_matches_jax():
    x = np.concatenate([
        np.geomspace(0.011, 1.3, 200), np.geomspace(1.7, 5e3, 200)
    ]).astype(np.float32)          # away from psi's root at 1.4616
    got = testep.digamma_approx(_t(x)).numpy()
    want = np.asarray(jestep.digamma_approx(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---- gamma fixed point (E-step kernel) ---------------------------------
def _estep_problem(b, l=64, k=5, v=300, seed=0, pad=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (b, l))
    cts = rng.integers(1, 6, (b, l)).astype(np.float32)
    cts[:, -pad:] = 0.0
    cts[b // 2] = 0.0                          # an empty doc
    lam = rng.gamma(100.0, 0.01, (k, v)).astype(np.float32)
    eb_full = np.asarray(jnp.exp(jlda.dirichlet_expectation(jnp.asarray(lam))))
    eb = np.ascontiguousarray(np.moveaxis(eb_full[:, ids], 0, 1))  # [B, k, L]
    alpha = np.full((k,), 1.0 / k, np.float32)
    g0 = rng.gamma(100.0, 0.01, (b, k)).astype(np.float32)
    return eb, cts, alpha, g0


@pytest.mark.parametrize(
    "b,tile_b,l,pad",
    [(16, 8, 64, 7), (13, 8, 64, 7), (11, 1, 64, 7), (5, 8, 64, 7),
     (12, 8, 4096, 2048)],
    ids=["16-8", "13-8", "11-1", "5-8", "en-width-12-5-4096-half-pad"],
)
def test_gamma_fixed_point_bkl_matches_pallas(b, tile_b, l, pad):
    """Normalized gamma within 5e-3 (the Pallas kernel's own bound vs the
    XLA loop).  Same algorithm and tile stop rule on both sides: the
    median per-doc difference is at the float32 rounding level (< 1e-5).
    The last case is an EN-books-like bucket: few docs, k=5, wide L with
    half of every doc's slots pad."""
    eb, cts, alpha, g0 = _estep_problem(b, l=l, pad=pad)
    want = jestep.gamma_fixed_point_pallas_bkl(
        jnp.asarray(eb), jnp.asarray(cts), jnp.asarray(alpha),
        jnp.asarray(g0), tile_b=tile_b, interpret=True,
    )
    got = testep.gamma_fixed_point_bkl(
        _t(eb), _t(cts), _t(alpha), _t(g0), tile_b=tile_b
    )
    assert got.shape == (b, eb.shape[1])
    diff = np.abs(_norm(got.numpy()) - _norm(want)).max(axis=1)
    assert diff.max() <= 5e-3
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("n_tiles,l,want", [
    (3, 16384, 16),    # EN books, most populated bucket [22, 5, 16384]
    (2, 32768, 16),    # EN books, widest bucket [12, 5, 32768]
    (582, 64, 1),      # 20NG, most populated bucket [4652, 20, 64]
    (2, 512, 4),       # 20NG, widest bucket [9, 20, 512]: 4 slices of L
    (1, 64, 1),        # one slice of L: never more CTAs than slices
    (20, 4096, 8),     # 20 x 8 = 160 CTAs fill the 132 SMs
    (132, 8192, 1),    # the tiles alone fill the SMs
])
def test_cluster_size_at_bucket_shapes(n_tiles, l, want):
    assert testep.cluster_size(n_tiles, l) == want


def test_cluster_size_bounds():
    """A power of two in 1..16, never more CTAs than 128-slot slices of L,
    and the smallest size that fills 132 SMs unless a bound stops it."""
    for n_tiles in (1, 2, 3, 5, 8, 17, 33, 66, 131, 132, 500):
        for l in (1, 31, 64, 128, 129, 256, 300, 1000, 2048, 4096, 32768):
            cs = testep.cluster_size(n_tiles, l)
            slices = -(-l // 128)
            assert cs in (1, 2, 4, 8, 16)
            assert cs <= slices
            fills = n_tiles * cs >= 132
            assert fills or cs == 16 or 2 * cs > slices
            assert cs == 1 or n_tiles * (cs // 2) < 132
    assert testep.cluster_size(3, 16384, sms=6) == 2


def test_gamma_fixed_point_blk_contract():
    """The [B, L, k] wrapper equals the [B, k, L] function."""
    eb, cts, alpha, g0 = _estep_problem(9, seed=3)
    blk = np.ascontiguousarray(np.transpose(eb, (0, 2, 1)))
    a = testep.gamma_fixed_point(_t(blk), _t(cts), _t(alpha), _t(g0))
    b = testep.gamma_fixed_point_bkl(_t(eb), _t(cts), _t(alpha), _t(g0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jestep.gamma_fixed_point_pallas(
        jnp.asarray(blk), jnp.asarray(cts), jnp.asarray(alpha),
        jnp.asarray(g0), interpret=True,
    )
    np.testing.assert_allclose(_norm(a.numpy()), _norm(want), atol=5e-3)


@pytest.mark.parametrize("freeze", [False, True])
def test_gamma_fixed_point_segments_matches_jax(freeze):
    rng = np.random.default_rng(4)
    k, t, b = 5, 400, 12
    eb_tok = rng.random((t, k)).astype(np.float32) + 0.01
    cts = rng.integers(0, 5, t).astype(np.float32)
    seg = np.sort(rng.integers(0, b, t)).astype(np.int32)
    alpha = np.full((k,), 0.2, np.float32)
    g0 = np.ones((b, k), np.float32)
    want, _ = jlda.gamma_fixed_point_segments(
        jnp.asarray(eb_tok), jnp.asarray(cts), jnp.asarray(seg),
        jnp.asarray(alpha), jnp.asarray(g0), 100, 1e-3, freeze=freeze,
    )
    got, _ = tlda.gamma_fixed_point_segments(
        _t(eb_tok), _t(cts), _t(seg), _t(alpha), _t(g0), 100, 1e-3,
        freeze=freeze,
    )
    np.testing.assert_allclose(_norm(got.numpy()), _norm(want), atol=1e-4)


def test_gamma_fixed_point_batch_matches_jax():
    eb, cts, alpha, g0 = _estep_problem(10, seed=5)
    blk = np.ascontiguousarray(np.transpose(eb, (0, 2, 1)))
    want, _ = jlda._gamma_fixed_point(
        jnp.asarray(blk), jnp.asarray(cts), jnp.asarray(alpha),
        jnp.asarray(g0), 100, 1e-3,
    )
    got, _ = tlda.gamma_fixed_point_batch(
        _t(blk), _t(cts), _t(alpha), _t(g0), 100, 1e-3
    )
    np.testing.assert_allclose(_norm(got.numpy()), _norm(want), atol=1e-4)


# ---- scatter plan ------------------------------------------------------
@pytest.mark.parametrize(
    "s_d,n_model,shard_v,t_local,vt,tb",
    [(1, 1, 700, 900, 256, 128), (2, 2, 512, 600, 256, 128),
     (1, 1, 3000, 5000, 256, 1024), (1, 1, 100, 64, 256, 128)],
)
def test_plan_matches_jax(s_d, n_model, shard_v, t_local, vt, tb):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, shard_v * n_model, (s_d, t_local)).astype(np.int32)
    cts = rng.random((s_d, t_local)).astype(np.float32)
    cts[rng.random((s_d, t_local)) < 0.2] = 0.0
    want = jscatter.plan_em_scatter(ids, cts, n_model, shard_v, vt=vt, tb=tb)
    got = tscatter.plan_em_scatter(ids, cts, n_model, shard_v, vt=vt, tb=tb)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


# ---- two-stage scatter --------------------------------------------------
@pytest.mark.parametrize("tb,want", [(1024, 512), (512, 512), (128, 128),
                                     (1536, 512), (1000, 500), (7, 7),
                                     (1031, 1)])
def test_scatter_piece_divides_the_block(tb, want):
    """A thread block of the scatter kernel takes the largest divisor of
    tb up to 512 slots, so no piece spans two token blocks."""
    piece = tscatter.scatter_piece(tb)
    assert piece == want and tb % piece == 0 and piece <= 512


@pytest.mark.parametrize(
    "k,shard_v,t_local,hot,tile0",
    [(5, 700, 900, 0, 0), (20, 3000, 5000, 0, 0), (64, 700, 1200, 0, 0),
     (20, 700, 1200, 450, 0), (5, 700, 1200, 0, 3000)],
    ids=["5-700-900", "20-3000-5000", "64-700-1200", "hot-column",
         "many-block-tile"],
)
def test_scatter_add_vtiles_matches_pallas(k, shard_v, t_local, hot, tile0):
    """``hot`` extra tokens of column 7 make one run across >= 3 blocks of
    128; ``tile0`` extra tokens in columns 0-255 give tile 0 >= 16 blocks."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, shard_v, (1, t_local)).astype(np.int32)
    if hot or tile0:
        extra = np.concatenate([np.full(hot, 7), rng.integers(0, 256, tile0)])
        ids = np.concatenate([ids, extra[None].astype(np.int32)], axis=1)
        t_local = ids.shape[1]
    cts = rng.random((1, t_local)).astype(np.float32) + 0.1
    cts[0, rng.random(t_local) < 0.2] = 0.0
    plan = tscatter.plan_em_scatter(ids, cts, 1, shard_v, vt=256, tb=128)
    lids, bv = plan.lids[0, 0, :, 0], plan.block_vtile[0, 0]
    if hot:
        assert ((lids == 7) & (bv[:, None] == 0)).any(1).sum() >= 3
    if tile0:
        assert (bv == 0).sum() >= 16
    wphi = rng.random((t_local, k)).astype(np.float32) * (cts[0] > 0)[:, None]
    wsorted = np.concatenate([wphi, np.zeros((1, k), np.float32)])[
        plan.sort_order[0]
    ]
    geo = dict(n_vtiles=plan.n_vtiles, nb=plan.nb, vt=plan.vt, tb=plan.tb,
               shard_v=shard_v)
    want = jscatter.scatter_add_vtiles(
        jnp.asarray(wsorted), jnp.asarray(plan.lids[0, 0]),
        jnp.asarray(plan.block_vtile[0, 0]),
        jnp.asarray(plan.block_first[0, 0]), interpret=True, **geo,
    )
    got = tscatter.scatter_add_vtiles(
        _t(wsorted), _t(plan.lids[0, 0]), _t(plan.block_vtile[0, 0]), **geo,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---- fused sweep --------------------------------------------------------
@pytest.mark.parametrize("shard_v,t_local,k,d", [(700, 900, 4, 13),
                                                 (3000, 5000, 5, 40),
                                                 (100, 64, 7, 8),
                                                 (700, 1200, 20, 300),
                                                 (700, 1200, 40, 512)])
def test_em_sweep_fused_matches_pallas(shard_v, t_local, k, d):
    """The port's sweep (the plain version, given the doc stream that
    ``doc_stream`` builds) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, shard_v, (1, t_local)).astype(np.int32)
    cts = rng.random((1, t_local)).astype(np.float32) + 0.1
    cts[0, rng.random(t_local) < 0.2] = 0.0
    seg = rng.integers(0, d, (1, t_local)).astype(np.int32)
    plan = tscatter.plan_em_scatter(ids, cts, 1, shard_v, vt=256, tb=128)
    d_pad = tsweep.fused_d_pad(d)
    n_wk = rng.random((k, shard_v)).astype(np.float32) + 0.5
    n_dk = rng.random((d, k)).astype(np.float32) + 0.5
    inv_denom = (1.0 / (n_wk.sum(1) + ETA * shard_v - shard_v)).astype(
        np.float32)
    docf = np.zeros((k, d_pad), np.float32)
    docf[:, :d] = (n_dk + (ALPHA - 1.0)).T
    so = plan.sort_order[0]
    blk = (plan.nb, 1, plan.tb)
    seg_s = np.concatenate([seg[0], [0]])[so].reshape(blk).astype(np.int32)
    cts_s = np.concatenate([cts[0], [0.0]])[so].reshape(blk).astype(np.float32)
    geo = dict(n_vtiles=plan.n_vtiles, nb=plan.nb, vt=plan.vt, tb=plan.tb,
               d_pad=d_pad, shard_v=shard_v, eta_m1=ETA - 1.0)
    args = (n_wk, docf, inv_denom, plan.lids[0, 0], seg_s, cts_s,
            plan.block_vtile[0, 0], plan.block_first[0, 0])
    w_nwk, w_ndk = jsweep.em_sweep_fused(
        *map(jnp.asarray, args), interpret=True, **geo
    )
    targs = tuple(map(_t, args[:7]))
    stream = tsweep.doc_stream(*targs[3:6], targs[6], plan.vt)
    g_nwk, g_ndk = tsweep.em_sweep_fused(*targs, *stream, **geo)
    np.testing.assert_allclose(g_nwk.numpy(), np.asarray(w_nwk),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_ndk.numpy(), np.asarray(w_ndk),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d_max,k,want", [
    (51, 5, True), (512, 5, True), (512, 20, True), (513, 5, False),
    (8, 500, True), (11_314, 20, False), (512, 40, True),
])
def test_fused_gate(d_max, k, want):
    """The fused sweep takes d <= 512 docs, the JAX package's bound, on
    every device and at every k: the kernel's shared memory does not grow
    with d * k (k is listed for the geometries the card once refused;
    ``test_em_sweep_source_on_cpu_threads`` runs the kernel at (512, 40)
    and (8, 500), ``chip_smoke.py`` on the card).  The JAX package's own
    gate also prices k=500 out; there the port's fused sweep gives the
    same sums as JAX's two-stage one."""
    assert tsweep.fused_eligible(d_max) is want
    assert tsweep.fused_eligible(d_max) is (d_max <= jsweep.MAX_FUSED_DOC_SLOTS)


@pytest.fixture(scope="module")
def sweep_kernel_on_cpu(tmp_path_factory):
    """csrc/emsweep.cu itself, compiled by g++ against the CPU stand-in for
    the CUDA runtime (``cuda_shim``)."""
    return build_on_cpu(
        "emsweep", "term_table_kernel|sweep_pieces_kernel|sweep_link_kernel",
        3, tmp_path_factory.mktemp("sweep_kernel"))


def _sweep_source_case(case):
    """(k, shard_v, d, ids, cts, seg) of a packed corpus (seg
    nondecreasing, 20% zero weights) for one edge of the kernel."""
    rng = np.random.default_rng(sum(map(ord, case)))
    k, v, d, t = dict(
        k5=(5, 700, 13, 900), hot_run=(5, 700, 13, 600),
        long_doc=(5, 700, 4, 2400), all_pad=(5, 1000, 13, 900),
        packed_stream=(5, 700, 13, 900), d512_k40=(40, 700, 512, 1200),
        d8_k500=(500, 300, 8, 200), k33=(33, 700, 13, 900),
    )[case]
    ids = rng.integers(0, v, t)
    if case == "hot_run":      # column 7: one run over >= 3 pieces of 128
        ids = np.concatenate([ids, np.full(450, 7)])
    if case == "all_pad":      # no token in tile 2: an all-pad block
        ids = np.where((ids >= 512) & (ids < 768), ids - 256, ids)
    seg = np.sort(rng.integers(0, d, ids.size))
    if case == "long_doc":     # doc 1 holds 2,000 tokens: >= 3 doc pieces
        seg = np.sort(np.concatenate([seg[:400], np.ones(ids.size - 400, int)]))
    cts = (rng.random(ids.size) + 0.1).astype(np.float32)
    cts[rng.random(ids.size) < 0.2] = 0.0
    return k, v, d, ids.astype(np.int32), cts, seg.astype(np.int32)


@pytest.mark.parametrize("case", ["k5", "hot_run", "long_doc", "all_pad",
                                  "packed_stream", "d512_k40", "d8_k500",
                                  "k33"])
def test_em_sweep_source_on_cpu_threads(sweep_kernel_on_cpu, case):
    """The CUDA kernel's own source, run on CPU threads, against the plain
    version within rtol 1e-4, atol 1e-5 (phi's sum over k and the run
    sums go in another order), a bit-for-bit repeat, and exact zeros for
    columns and docs no token hits.  Cases: k=5 with V=700 (no multiple
    of vt=256); a column's run over >= 3 vocab pieces; a doc over >= 3 doc
    pieces; an all-pad vocab piece; the doc stream as the fit passes it
    (the packed tokens, zero weights included); d=512 with k=40 (the doc
    factor read through L1/L2: d_pad * k > 4,096); d=8 with k=500 (16
    topic slices, the doc factor in shared memory); k=33 (a slice of one
    topic)."""
    lib = sweep_kernel_on_cpu
    k, v, d, ids, cts, seg = _sweep_source_case(case)
    vt, tb = 256, 128
    plan = tscatter.plan_em_scatter(ids[None], cts[None], 1, v, vt=vt, tb=tb)
    so, blk = plan.sort_order[0], (plan.nb, 1, plan.tb)
    lids, bv = plan.lids[0, 0], plan.block_vtile[0, 0]
    seg_s = np.concatenate([seg, [0]])[so].reshape(blk).astype(np.int32)
    cts_s = np.concatenate([cts, [0.0]])[so].reshape(blk).astype(np.float32)
    d_pad = tsweep.fused_d_pad(d)
    rng = np.random.default_rng(k + d)
    nwk = (rng.random((k, v)) + 0.5).astype(np.float32)
    docf = np.zeros((k, d_pad), np.float32)
    docf[:, :d] = rng.random((k, d)) + ALPHA - 1.0
    inv = (1.0 / (nwk.sum(1) + ETA * v - v)).astype(np.float32)
    if case == "packed_stream":
        stream = (ids, cts, seg)
    else:
        stream = [x.numpy() for x in tsweep.doc_stream(
            _t(lids), _t(seg_s), _t(cts_s), _t(bv), vt)]
    vpiece, dpiece = tscatter.scatter_piece(tb), tsweep._DOC_PIECE
    n_vpieces = plan.nb * (tb // vpiece)
    n_pieces = n_vpieces + -(-stream[0].size // dpiece)
    piece_lids = lids.reshape(n_vpieces, vpiece)
    if case == "hot_run":
        assert ((piece_lids == 7) & (np.repeat(bv, tb // vpiece) == 0)[:, None]
                ).any(1).sum() >= 3
    if case == "long_doc":
        assert -(-(stream[2] == 1).sum() // dpiece) >= 3
    if case == "all_pad":
        assert (piece_lids < 0).all(1).any()

    def run():
        out = np.full(k * v + d_pad * k, np.nan, np.float32)
        term = np.full(v * -(-k // 8) * 8, np.nan, np.float32)
        meta = np.full((n_pieces, 4), -7, np.int32)
        part = np.full((n_pieces, 2, k), np.nan, np.float32)
        err = lib.stc_em_sweep_fused(
            nwk.ctypes.data, docf.ctypes.data, inv.ctypes.data,
            lids.ctypes.data, seg_s.ctypes.data, cts_s.ctypes.data,
            bv.ctypes.data, stream[0].ctypes.data, stream[1].ctypes.data,
            stream[2].ctypes.data, plan.nb, tb, vpiece, stream[0].size,
            dpiece, k, vt, d_pad, v, ETA - 1.0, out.ctypes.data,
            out[k * v:].ctypes.data, term.ctypes.data, meta.ctypes.data,
            part.ctypes.data, None)
        assert err == 0
        return out[:k * v].reshape(k, v), out[k * v:].reshape(d_pad, k)

    got_nwk, got_ndk = run()
    again_nwk, again_ndk = run()
    np.testing.assert_array_equal(again_nwk, got_nwk)
    np.testing.assert_array_equal(again_ndk, got_ndk)
    want_nwk, want_ndk = tsweep.em_sweep_fused_plain(
        *map(_t, (nwk, docf, inv, lids, seg_s, cts_s, bv, *stream)),
        n_vtiles=plan.n_vtiles, nb=plan.nb, vt=vt, tb=tb, d_pad=d_pad,
        shard_v=v, eta_m1=ETA - 1.0)
    np.testing.assert_allclose(got_nwk, want_nwk.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_ndk, want_ndk.numpy(), rtol=1e-4,
                               atol=1e-5)
    live = cts > 0
    hit_cols = np.zeros(v, bool)
    hit_cols[ids[live]] = True
    hit_docs = np.zeros(d_pad, bool)
    hit_docs[seg[live]] = True
    assert not got_nwk[:, ~hit_cols].any() and got_nwk[:, hit_cols].all()
    assert not got_ndk[~hit_docs].any() and got_ndk[hit_docs].all()


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the kernel library does not build: the
    wrappers raise on a CUDA tensor rather than fall back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library("estep")


def test_launch_counters_start_at_zero_and_reset():
    assert set(_build.LAUNCHES) == {
        "gamma_fixed_point_bkl", "scatter_add_vtiles", "em_sweep_fused",
        "gamma_fixed_point_tiles", "nmf_mu_update_tiles",
    }
    _build.LAUNCHES["em_sweep_fused"] += 3
    _build.reset_launches()
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["estep", "scatter", "sweep", "tiles",
                                    "nmf"])
def test_wrappers_never_fall_back_off_the_cpu(kernel):
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper checks it and raises before any launch (here: 'meta' tensors,
    which are not on the card)."""
    m = dict(device="meta")
    f32 = dict(dtype=torch.float32, **m)
    i32 = dict(dtype=torch.int32, **m)
    with pytest.raises(ValueError):
        if kernel == "estep":
            testep.gamma_fixed_point_bkl(
                torch.empty(4, 5, 16, **f32), torch.empty(4, 16, **f32),
                torch.ones(5, **f32), torch.empty(4, 5, **f32))
        elif kernel == "tiles":
            tpacked.gamma_fixed_point_tiles(
                torch.empty(5, 2 * 512, **f32), torch.empty(2, 512, **f32),
                torch.empty(2, 512, **i32), torch.ones(5, **f32),
                torch.empty(5, 2 * 128, **f32), d=128)
        elif kernel == "nmf":
            tnmf.nmf_mu_update_tiles(
                torch.empty(5, 2 * 512, **f32), torch.empty(2, 512, **f32),
                torch.empty(2, 512, **i32), torch.empty(2 * 128, 5, **f32),
                torch.empty(5, 5, **f32), d=128)
        elif kernel == "scatter":
            tscatter.scatter_add_vtiles(
                torch.empty(256, 5, **f32), torch.empty(2, 1, 128, **i32),
                torch.empty(2, **i32),
                n_vtiles=1, nb=2, vt=256, tb=128, shard_v=200)
        else:
            tsweep.em_sweep_fused(
                torch.empty(5, 200, **f32), torch.empty(5, 8, **f32),
                torch.empty(5, **f32), torch.empty(2, 1, 128, **i32),
                torch.empty(2, 1, 128, **i32), torch.empty(2, 1, 128, **f32),
                torch.empty(2, **i32), torch.empty(100, **i32),
                torch.empty(100, **f32), torch.empty(100, **i32),
                n_vtiles=1, nb=2, vt=256, tb=128, d_pad=8, shard_v=200,
                eta_m1=0.1)
