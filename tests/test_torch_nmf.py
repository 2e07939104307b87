"""The port's NMF (tile W-update kernel, sweeps, fit, W solve, persistence,
facade) held against the JAX package's.

Torch cannot replay JAX's uniform draws, so the fit parity tests hand the
port the JAX package's own W0/H0 (``NMF._w_init``) through
``nmf_init_from_numpy``.  The JAX side runs its Pallas kernel in interpret
mode on a 1x1 CPU mesh; the port runs with ``device="cpu"``, which takes
the kernel's plain version.  The CUDA kernel's own source, compiled by g++
against the CPU stand-in for the CUDA runtime in ``cuda_shim``, is held
against the plain version on CPU threads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.nmf import (
    NMF as JNMF,
    NMFModel as JNMFModel,
    NMFTrainState,
    frobenius_loss as j_frobenius_loss,
    make_nmf_packed_runner,
    make_nmf_train_step,
)
from spark_text_clustering_tpu.models.persistence import (
    load_model as j_load_model,
)
from spark_text_clustering_tpu.ops.pallas_nmf import (
    nmf_mu_update_tiles as j_nmf_mu_update_tiles,
)
from spark_text_clustering_tpu.ops.sparse import (
    batch_from_rows as j_batch_from_rows,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu_torch import (
    LDA, NMF, NMFEstimator, NMFModel, Params, load_model,
)
from spark_text_clustering_tpu_torch.interop import (
    nmf_init_from_numpy,
    nmf_model_from_numpy,
)
from spark_text_clustering_tpu_torch.models.nmf import (
    frobenius_loss,
    packed_sweeps,
    padded_step,
)
from spark_text_clustering_tpu_torch.ops.nmf import nmf_mu_update_tiles_plain
from spark_text_clustering_tpu_torch.ops.packed import plan_corpus_tiles
from spark_text_clustering_tpu_torch.ops.sparse import batch_from_rows

from cuda_shim import build_on_cpu


def _mesh():
    return make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])


def _skewed(n_docs=200, v=1000, seed=7, zero_doc=5):
    """Lognormal doc lengths (a heavy tail makes "auto" pick the packed
    layout); doc ``zero_doc`` has only zero-weight tokens."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_docs):
        nnz = int(np.clip(rng.lognormal(2.5, 1.0), 1, 300))
        ids = np.sort(rng.choice(v, size=nnz, replace=False))
        rows.append((ids.astype(np.int32),
                     rng.integers(1, 6, size=nnz).astype(np.float32)))
    if zero_doc is not None:
        rows[zero_doc] = (rows[zero_doc][0], np.zeros_like(rows[zero_doc][1]))
    return rows, [f"t{i}" for i in range(v)]


def _flat(rows):
    n = len(rows)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
    return (np.concatenate([i for i, _ in rows]),
            np.concatenate([w for _, w in rows]), offsets)


def _jax_init(rows, k, v, seed):
    """The JAX estimator's own scaled-uniform draws for ``rows``."""
    weight_sum = float(np.concatenate([w for _, w in rows]).sum())
    jopt = JNMF(JParams(k=k, seed=seed), mesh=_mesh())
    return jopt._w_init(len(rows), k, v, weight_sum)


@pytest.mark.parametrize("k", [5, 20])
def test_plain_kernel_matches_pallas(k):
    """The plain W update against the Pallas kernel in interpret mode on
    plan-made inputs (several tiles, pad tokens, pad slots, a doc whose
    tokens all have cts == 0): w_new and vals within rtol 1e-5 / atol 1e-7
    (measured ~4e-7 relative: the numerator sums in another order); pad
    tokens' vals and token-less slots' w_new exactly 0 in both."""
    rows, vocab = _skewed()
    n, v = len(rows), len(vocab)
    plan = plan_corpus_tiles(*_flat(rows), k=k)
    n_tiles, d = plan.ids.shape[0], plan.d
    assert n_tiles >= 3 and (plan.seg == d).any()
    rng = np.random.default_rng(k)
    h = rng.uniform(0.1, 1.0, (k, v)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (n_tiles * d, k)).astype(np.float32)
    hht = h @ h.T
    hg = np.ascontiguousarray(h[:, plan.ids.reshape(-1)])
    want_w, want_v = j_nmf_mu_update_tiles(
        jnp.asarray(hg), jnp.asarray(plan.cts), jnp.asarray(plan.seg),
        jnp.asarray(w), jnp.asarray(hht), d=d, interpret=True)
    got_w, got_v = nmf_mu_update_tiles_plain(
        torch.from_numpy(hg), torch.from_numpy(plan.cts),
        torch.from_numpy(plan.seg), torch.from_numpy(w),
        torch.from_numpy(hht), d)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-5, atol=1e-7)
    pad_tok = plan.seg.reshape(-1) == d
    assert not got_v.numpy()[pad_tok].any()
    # slots no token reaches: pad slots and the all-zero doc's slot
    reached = np.zeros(n_tiles * d, bool)
    tile = np.repeat(np.arange(n_tiles), plan.tt)
    live = ~pad_tok
    reached[(tile * d + plan.seg.reshape(-1))[live]] = True
    assert (~reached).sum() > n_tiles * d - n
    assert not got_w.numpy()[~reached].any()
    assert not np.asarray(want_w)[~reached].any()


@pytest.fixture(scope="module")
def nmf_kernel_on_cpu(tmp_path_factory):
    """csrc/nmf.cu itself, compiled by g++ against the CPU stand-in for the
    CUDA runtime (``cuda_shim``)."""
    return build_on_cpu("nmf", "mu_kernel", 2,
                        tmp_path_factory.mktemp("nmf_kernel"))


def _hand_tiles(tiles, tt, d, seed, zero_slots=()):
    """cts and seg [n_tiles, tt] laid out as the planner lays them: per
    tile a list of doc lengths (0 for a slot with no token) in slot order,
    live tokens first, pad tokens (seg == d, cts == 0) after.  Slots in
    ``zero_slots`` (tile, slot) keep their tokens at cts == 0."""
    rng = np.random.default_rng(seed)
    cts = np.zeros((len(tiles), tt), np.float32)
    seg = np.full((len(tiles), tt), d, np.int32)
    for i, lens in enumerate(tiles):
        s = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
        assert len(s) <= tt and len(lens) <= d
        seg[i, :len(s)] = s
        cts[i, :len(s)] = rng.integers(1, 6, len(s))
        for ti, slot in zero_slots:
            if ti == i:
                cts[i, :len(s)][s == slot] = 0.0
    return cts, seg


def _nmf_kernel_case(case):
    """(k, d, cts, seg, zero-weight slots) of one CPU-thread case."""
    rng = np.random.default_rng(11)
    if case in ("k20", "k33", "k300_scratch"):
        k = {"k20": 20, "k33": 33, "k300_scratch": 300}[case]
        plan = plan_corpus_tiles(*_flat(_skewed()[0]), k=k)
        sel = [0, 2] if case == "k20" else [0]
        return k, plan.d, plan.cts[sel].copy(), plan.seg[sel].copy(), ()
    if case == "long_doc":
        return (20, 128) + _hand_tiles([[512]], 512, 128, 1) + ((),)
    if case == "all_pad":
        lens = [40, 0, 25, 70, 3, 90]
        return (20, 128) + _hand_tiles([lens, []], 512, 128, 2) + ((),)
    if case == "zero_weight":
        zero = ((0, 1), (0, 4))
        return (20, 128) + _hand_tiles([[30, 12, 50, 33, 7]], 512, 128, 3,
                                       zero) + (zero,)
    if case == "tt1024":
        lens = rng.integers(1, 90, 20)
        return (20, 128) + _hand_tiles([lens], 1024, 128, 4) + ((),)
    # d2048_scratch: 300 docs of 0-2 tokens in 2,048 slots
    lens = rng.integers(0, 3, 300)
    return (20, 2048) + _hand_tiles([lens], 512, 2048, 5) + ((),)


_NMF_CPU_CASES = ["k20", "k33", "long_doc", "all_pad", "zero_weight",
                  "tt1024", "d2048_scratch", "k300_scratch"]


@pytest.mark.parametrize("case", _NMF_CPU_CASES)
def test_nmf_kernel_source_on_cpu_threads(nmf_kernel_on_cpu, case):
    """The CUDA kernel's own source, run on CPU threads, against the plain
    version: w_new and vals within rtol 1e-4 (the numerator and the
    denominator sum in another order), a bit-for-bit repeat, and exact
    zeros for pad tokens' vals and for the w_new of slots no token
    reaches.  Covers planner tiles at k=20 and at k=33 (lanes loop past 32
    topics), a 512-token doc over 16 warps, an all-pad tile beside a live
    one, slots reached only by zero-weight tokens, tt=1024 (two token
    slots a thread, 64-token warp ranges), and the piece table in the
    scratch buffer (d=2048; k=300, with H H^T read from global memory)."""
    from spark_text_clustering_tpu_torch.ops.packed import tile_warps

    lib = nmf_kernel_on_cpu
    k, d, cts, seg, zero = _nmf_kernel_case(case)
    n_tiles, tt = cts.shape
    warps = tile_warps(tt)
    rng = np.random.default_rng(k + d)
    hg = rng.uniform(0.1, 1.0, (k, n_tiles * tt)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (n_tiles * d, k)).astype(np.float32)
    hk = rng.uniform(0.1, 1.0, (k, 64)).astype(np.float32)
    hht = hk @ hk.T
    per_tile = lib.stc_nmf_scratch_floats(k, d, tt, warps)
    assert lib.stc_nmf_smem_bytes(k, d, tt, warps) > 0
    assert (per_tile > 0) == case.endswith("_scratch")

    def run():
        w_out = np.full((n_tiles * d, k), np.nan, np.float32)
        vals = np.full((n_tiles * tt, k), np.nan, np.float32)
        scratch = np.full(max(1, n_tiles * per_tile), np.nan, np.float32)
        err = lib.stc_nmf_mu_update_tiles(
            hg.ctypes.data, cts.ctypes.data, seg.ctypes.data, w.ctypes.data,
            hht.ctypes.data, n_tiles, k, tt, d, warps, 1e-9,
            w_out.ctypes.data, vals.ctypes.data,
            scratch.ctypes.data if per_tile else None, None)
        assert err == 0
        return w_out, vals

    got_w, got_v = run()
    again_w, again_v = run()
    np.testing.assert_array_equal(again_w, got_w)
    np.testing.assert_array_equal(again_v, got_v)
    want_w, want_v = nmf_mu_update_tiles_plain(
        torch.from_numpy(hg), torch.from_numpy(cts), torch.from_numpy(seg),
        torch.from_numpy(w), torch.from_numpy(hht), d)
    np.testing.assert_allclose(got_w, want_w.numpy(), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(got_v, want_v.numpy(), rtol=1e-4, atol=1e-8)
    pad_tok = seg.reshape(-1) == d
    assert not got_v[pad_tok].any()
    tile = np.repeat(np.arange(n_tiles), tt)
    reached = np.zeros(n_tiles * d, bool)
    reached[(tile * d + seg.reshape(-1))[~pad_tok]] = True
    assert not got_w[~reached].any()
    assert got_w[reached].any(axis=1).sum() == reached.sum() - len(zero)
    for ti, slot in zero:
        assert reached[ti * d + slot] and not got_w[ti * d + slot].any()
        assert not got_v[(tile * d + seg.reshape(-1)) == ti * d + slot].any()


def test_packed_plan_matches_jax():
    """The flat layout's packing equals the JAX package's element for
    element."""
    rows, vocab = _skewed()
    want = JNMF(JParams(k=3), mesh=_mesh())._packed_plan(rows, len(rows))
    got = NMF(Params(k=3), device="cpu")._packed_plan(rows, len(rows))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["tiles", "flat"])
def test_runner_matches_jax(layout):
    """Five sweeps and the loss of the port's packed runner against
    ``make_nmf_packed_runner`` (tiles: the Pallas kernel in interpret
    mode; flat: the XLA segment ops) from the same W0/H0: W and H within
    rtol 1e-4 (measured ~5e-6 on H), loss within 1e-5 relative."""
    rows, vocab = _skewed()
    n, v, k = len(rows), len(vocab), 5
    w_doc, h0 = _jax_init(rows, k, v, seed=2)
    flat_ids, flat_cts, offsets = _flat(rows)
    x2 = float((flat_cts.astype(np.float64) ** 2).sum())
    if layout == "tiles":
        plan = plan_corpus_tiles(flat_ids, flat_cts, offsets, k=k)
        ids, cts, seg, d = plan.ids, plan.cts, plan.seg, plan.d
        w0 = np.zeros((ids.shape[0] * d, k), np.float32)
        live = plan.doc_ids.reshape(-1) < n
        w0[live] = w_doc[plan.doc_ids.reshape(-1)[live]]
        run = make_nmf_packed_runner(_mesh(), d=d, interpret=True)
    else:
        ids, cts, seg, slot, d_max, _ = JNMF(
            JParams(k=k), mesh=_mesh())._packed_plan(rows, n)
        d = None
        w0 = np.zeros((d_max, k), np.float32)
        w0[slot] = w_doc
        run = make_nmf_packed_runner(_mesh())
    jw, jh, jloss = run(jnp.asarray(w0), jnp.asarray(h0), jnp.asarray(ids),
                        jnp.asarray(cts), jnp.asarray(seg), x2, 5)
    tw, th, tloss = packed_sweeps(
        torch.from_numpy(w0), torch.from_numpy(h0), torch.from_numpy(ids),
        torch.from_numpy(cts), torch.from_numpy(seg), x2, 5, d=d)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-7)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


def test_padded_step_matches_jax(tiny_corpus_rows):
    """Five padded sweeps against ``make_nmf_train_step`` and the padded
    Frobenius loss against the JAX package's: W and H within rtol 1e-4,
    loss within 1e-5 relative."""
    rows, vocab = tiny_corpus_rows
    k, v = 4, len(vocab)
    w0, h0 = _jax_init(rows, k, v, seed=3)
    jbatch = j_batch_from_rows(rows)
    step = make_nmf_train_step(_mesh())
    state = NMFTrainState(jnp.asarray(w0), jnp.asarray(h0))
    batch = batch_from_rows(rows)
    w, h = torch.from_numpy(w0), torch.from_numpy(h0)
    for _ in range(5):
        state = step(state, jbatch)
        w, h = padded_step(w, h, batch.token_ids, batch.token_weights)
    np.testing.assert_allclose(w.numpy(), np.asarray(state.w), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(h.numpy(), np.asarray(state.h), rtol=1e-4,
                               atol=1e-7)
    want = float(j_frobenius_loss(jbatch, state.w, state.h))
    assert float(frobenius_loss(batch, w, h)) == pytest.approx(want, rel=1e-5)


def _fit_cases():
    return [("packed", "tiny"), ("padded", "tiny"), ("auto", "skewed")]


@pytest.mark.parametrize("layout,corpus", _fit_cases(),
                         ids=[f"{a}-{b}" for a, b in _fit_cases()])
def test_fit_matches_jax(layout, corpus, tiny_corpus_rows, monkeypatch):
    """A whole fit from the JAX package's draws, against JAX ``NMF.fit``
    with its Pallas tile kernel (interpret mode): H within rtol 1e-3 /
    atol 1e-5 (the band of JAX's own flat-vs-fused test; measured at most
    4.2e-5 relative), the same layout decision, loss within 1e-4 relative
    (measured at most 2.3e-7)."""
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    rows, vocab = tiny_corpus_rows if corpus == "tiny" else _skewed()
    k, v, iters = 4, len(vocab), 15
    kw = dict(k=k, max_iterations=iters, seed=3, token_layout=layout)
    jopt = JNMF(JParams(**kw), mesh=_mesh())
    jmodel = jopt.fit(rows, vocab)
    jmodel.ensure_host()
    if layout == "padded":
        weight_sum = float(np.asarray(j_batch_from_rows(rows).token_weights.sum()))
        w0, h0 = jopt._w_init(len(rows), k, v, weight_sum)
    else:
        w0, h0 = _jax_init(rows, k, v, seed=3)
    topt = NMF(Params(**kw), device="cpu")
    tmodel = topt.fit(rows, vocab, init=nmf_init_from_numpy(w0, h0))
    assert topt.last_layout == jopt.last_layout
    assert topt.last_mu_backend == {
        "pallas_tiles": "plain_tiles", "none": "none"}[jopt.last_mu_backend]
    assert topt.last_cells == jopt.last_cells
    np.testing.assert_allclose(tmodel.h, jmodel.h, rtol=1e-3, atol=1e-5)
    assert tmodel.loss == pytest.approx(jmodel.loss, rel=1e-4)
    assert topt.last_loss == tmodel.loss
    assert (tmodel.step, len(tmodel.iteration_times)) == (iters, iters)


def test_flat_layout_when_no_tile_fits():
    """A doc wider than the widest tile leaves no tile geometry: the fit
    takes the flat layout (by the plan, on any device), which matches the
    JAX package's flat XLA tier from the same draws (H rtol 1e-3 /
    atol 1e-5, loss 1e-4)."""
    rng = np.random.default_rng(4)
    v, k = 10_000, 3
    rows, vocab = _skewed(n_docs=30, v=v, zero_doc=None)
    wide = np.sort(rng.choice(v, size=8200, replace=False)).astype(np.int32)
    rows[0] = (wide, rng.integers(1, 4, wide.size).astype(np.float32))
    assert plan_corpus_tiles(*_flat(rows), k=k) is None
    kw = dict(k=k, max_iterations=5, seed=1, token_layout="auto")
    jopt = JNMF(JParams(**kw), mesh=_mesh())
    jmodel = jopt.fit(rows, vocab)
    jmodel.ensure_host()
    topt = NMF(Params(**kw), device="cpu")
    tmodel = topt.fit(rows, vocab, init=nmf_init_from_numpy(
        *_jax_init(rows, k, v, seed=1)))
    assert (topt.last_layout, topt.last_mu_backend) == ("packed", "flat")
    assert jopt.last_mu_backend == "xla" and topt.last_tiles is None
    assert topt.last_cells == jopt.last_cells
    np.testing.assert_allclose(tmodel.h, jmodel.h, rtol=1e-3, atol=1e-5)
    assert tmodel.loss == pytest.approx(jmodel.loss, rel=1e-4)


def test_own_init_is_seeded_and_scaled(tiny_corpus_rows):
    """Without ``init`` the fit draws W0/H0 from its seed: the same seed
    gives the same model, another seed another; a zero-sweep fit's loss
    is that of factors drawn from scale * [0.5, 1.5)."""
    rows, vocab = tiny_corpus_rows
    kw = dict(k=3, max_iterations=4, token_layout="packed")
    a = NMF(Params(seed=5, **kw), device="cpu").fit(rows, vocab)
    b = NMF(Params(seed=5, **kw), device="cpu").fit(rows, vocab)
    c = NMF(Params(seed=6, **kw), device="cpu").fit(rows, vocab)
    np.testing.assert_array_equal(a.h, b.h)
    assert not np.array_equal(a.h, c.h)
    opt = NMF(Params(seed=5, **kw), device="cpu")
    w, h = opt._init(len(rows), 3, len(vocab), 1.0 * len(rows) * len(vocab))
    scale = np.sqrt(1.0 / 3)
    for t in (w, h):
        assert 0.5 * scale <= float(t.min()) and float(t.max()) < 1.5 * scale


@pytest.mark.parametrize("n_iter", [1, 100])
def test_transform_matches_jax(n_iter):
    """The fixed-H W solve at exactly ``n_iter`` updates, and
    ``topic_distribution`` (an empty doc gets the uniform row) and
    ``describe_topics`` against the JAX ``NMFModel`` on the same H: W
    within rtol 1e-4 / atol 1e-7 (measured 2.5e-5 relative after 100
    updates: the fixed numerator sums in another order), distributions
    within atol 1e-5."""
    rows, vocab = _skewed(n_docs=60, zero_doc=None)
    rows = rows + [(np.zeros(0, np.int32), np.zeros(0, np.float32))]
    h = np.random.default_rng(9).gamma(1.0, 0.5, (4, len(vocab)))
    h = h.astype(np.float32)
    jmodel = JNMFModel(h=h, vocab=vocab)
    tmodel = nmf_model_from_numpy(h, vocab, device="cpu")
    np.testing.assert_allclose(tmodel.transform(rows, n_iter=n_iter),
                               jmodel.transform(rows, n_iter=n_iter),
                               rtol=1e-4, atol=1e-7)
    got = tmodel.topic_distribution(rows, n_iter=n_iter, mesh=None,
                                    convergence="per_doc")
    want = jmodel.topic_distribution(rows, n_iter=n_iter)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[-1], np.full(4, 0.25, np.float32))
    # the padded batch surface agrees with the row surface
    np.testing.assert_allclose(
        tmodel.transform(batch_from_rows(rows), n_iter=n_iter),
        tmodel.transform(rows, n_iter=n_iter), rtol=1e-6, atol=1e-9)
    assert tmodel.describe_topics(5) == jmodel.describe_topics(5)
    assert tmodel.describe_topics_terms(3) == jmodel.describe_topics_terms(3)
    with pytest.raises(ValueError, match="convergence"):
        tmodel.topic_distribution(rows, convergence="sometimes")


def test_nmf_persistence_both_ways(tmp_path, tiny_corpus_rows):
    """An NMF dir the JAX package saved loads in the port and scores the
    same (atol 1e-5); one the port saved loads in JAX ``load_model`` as an
    ``NMFModel`` with h, loss and step intact."""
    rows, vocab = tiny_corpus_rows
    kw = dict(k=3, max_iterations=6, seed=0, token_layout="packed")
    jmodel = JNMF(JParams(**kw), mesh=_mesh()).fit(rows, vocab)
    jmodel.save(str(tmp_path / "jax"))
    tback = load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(tback, NMFModel)
    np.testing.assert_array_equal(tback.h, np.asarray(jmodel.h))
    assert (tback.step, tback.vocab) == (6, vocab)
    assert tback.loss == pytest.approx(jmodel.loss, rel=1e-7)
    np.testing.assert_allclose(tback.topic_distribution(rows),
                               jmodel.topic_distribution(rows), atol=1e-5)

    tmodel = NMF(Params(**kw), device="cpu").fit(rows, vocab)
    tmodel.save(str(tmp_path / "port"))
    jback = j_load_model(str(tmp_path / "port"))
    assert isinstance(jback, JNMFModel)
    np.testing.assert_array_equal(np.asarray(jback.h), tmodel.h)
    assert (jback.step, jback.loss) == (6, pytest.approx(tmodel.loss))
    again = NMFModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.h, tmodel.h)


def test_pipeline_nmf(tiny_corpus_rows):
    """``LDA(Params(algorithm="nmf"))`` and ``NMFEstimator`` fit on the CPU
    (empty docs dropped for the fit, uniform in the distribution) and
    agree with each other."""
    rows, vocab = tiny_corpus_rows
    ds = {"rows": rows + [(np.zeros(0, np.int32), np.zeros(0, np.float32))],
          "vocab": vocab}
    params = Params(k=2, algorithm="nmf", max_iterations=8)
    fitted = LDA(params, device="cpu").fit(ds)
    assert isinstance(fitted.model, NMFModel) and fitted.corpus_size == 24
    assert fitted.log_likelihood is None
    dist = fitted.transform(ds)["topic_distribution"]
    assert dist.shape == (25, 2) and np.allclose(dist.sum(1), 1.0)
    # two planted topics over disjoint vocab halves: each doc picks its own
    top = dist[:24].argmax(1)
    assert (top[0::2] != top[1::2]).all()
    swap = NMFEstimator(params.replace(algorithm="em"), device="cpu").fit(ds)
    np.testing.assert_array_equal(swap.model.h, fitted.model.h)


_BAD = [
    ("tiles_layout", dict(token_layout="tiles"), ValueError, "token_layout"),
    ("sharded", dict(data_shards=2), ValueError, "needs 2 ranks"),
    ("model_sharded", dict(model_shards=2), ValueError,
     "not divisible by model_shards=2"),
]


@pytest.mark.parametrize("name,kw,exc,match", _BAD, ids=[c[0] for c in _BAD])
def test_unported_or_bad_settings_raise(name, kw, exc, match,
                                        tiny_corpus_rows):
    """A layout NMF has not and shards without the ranks of a started
    grid raise, instead of running on one device."""
    rows, vocab = tiny_corpus_rows
    with pytest.raises(exc, match=match):
        NMF(Params(k=2, **kw), device="cpu").fit(rows, vocab)


def test_init_of_the_wrong_shape_raises(tiny_corpus_rows):
    rows, vocab = tiny_corpus_rows
    bad = nmf_init_from_numpy(np.ones((3, 2)), np.ones((2, len(vocab))))
    with pytest.raises(ValueError, match="init"):
        NMF(Params(k=2), device="cpu").fit(rows, vocab, init=bad)
    with pytest.raises(ValueError, match="agree on k"):
        nmf_init_from_numpy(np.ones((3, 2)), np.ones((3, 4)))
