"""The port's online-VB paths beyond tiles-resident held against the JAX
package's: the samplers, the host-streaming packed path (flat and on
tiles), the padded resident and host paths, and the layout decisions.

Torch cannot reproduce JAX's threefry draws, so each iteration parity
test starts both packages from one lambda in ``train_state.npz`` and
feeds the port the JAX package's own gamma inits (``init_gamma_rows``).
The padded E-step stops per tile in the port on every device, as the JAX
kernel does, so the JAX side of the padded tests runs that kernel
(``STC_GAMMA_BACKEND=pallas``, interpret mode) on a 1x1 CPU mesh; the
port runs with ``device="cpu"``, which takes the kernels' plain versions.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import chip_smoke
from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.online_lda import (
    OnlineLDA as JOnlineLDA,
    TrainState,
    make_online_eb,
    make_online_estep,
    make_online_mstep,
    make_online_packed_chunk,
    make_online_packed_tiles_chunk,
    make_online_resident_chunk,
)
from spark_text_clustering_tpu.models.persistence import (
    save_train_state as j_save_train_state,
)
from spark_text_clustering_tpu.ops.lda_math import init_gamma_rows
from spark_text_clustering_tpu.ops.pallas_packed import (
    plan_tile_pack_uniform as j_plan_tile_pack_uniform,
)
from spark_text_clustering_tpu.ops.sparse import (
    DocTermBatch as JDocTermBatch,
    batch_from_rows as j_batch_from_rows,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu_torch import OnlineLDA, Params
from spark_text_clustering_tpu_torch.models.online_lda import (
    packed_iteration,
    padded_estep,
    padded_iteration,
    padded_mstep,
    tiles_iteration,
)
from spark_text_clustering_tpu_torch.models.persistence import load_train_state
from spark_text_clustering_tpu_torch.ops.packed import (
    docs_gamma_to_tiles,
    plan_corpus_tiles,
    plan_tile_pack_uniform,
)
from spark_text_clustering_tpu_torch.ops.sparse import (
    batch_from_rows,
    next_pow2,
)

TAU0, KAPPA, SHAPE, SEED = 1024.0, 0.51, 100.0, 0
K = 5


def _mesh():
    return make_mesh(data_shards=1, model_shards=1,
                     devices=jax.devices("cpu")[:1])


def _rows(n_docs, seed, lengths):
    rng = np.random.default_rng(seed)
    v = 1000
    rows = []
    for _ in range(n_docs):
        nnz = int(lengths(rng))
        ids = np.sort(rng.choice(v, size=nnz, replace=False))
        rows.append((ids.astype(np.int32),
                     rng.integers(1, 6, size=nnz).astype(np.float32)))
    return rows, [f"t{i}" for i in range(v)]


def _skewed(n_docs=200, seed=7):
    """Doc lengths log-normal over 1-300 terms: "auto" packs."""
    return _rows(n_docs, seed,
                 lambda r: np.clip(r.lognormal(2.5, 1.0), 1, 300))


def _even(n_docs=40, seed=9):
    """Doc lengths 20-40 terms: "auto" pads."""
    return _rows(n_docs, seed, lambda r: r.integers(20, 41))


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


def _lam0(tmp_path, k, v):
    """One lambda written by the JAX package to train_state.npz and read
    back by the port."""
    lam = np.random.default_rng(3).gamma(SHAPE, 1 / SHAPE, (k, v))
    path = str(tmp_path / "train_state.npz")
    j_save_train_state(path, 0, lam=lam.astype(np.float32))
    return load_train_state(path, require=("lam",))["lam"]


def _jax_gamma0(step, doc_ids):
    """The JAX package's gamma inits of ``doc_ids`` at ``step``."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    return np.array(init_gamma_rows(key, jnp.asarray(doc_ids), K, SHAPE))


def _picks(n, bsz, m=3, seed=5):
    """m minibatches of bsz positions: real docs, then pad ids n, n+1..."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(m):
        real = rng.choice(n, size=bsz - 2 - j, replace=False)
        out.append(np.concatenate([real, np.arange(n, n + 2 + j)]))
    return np.stack(out).astype(np.int32)


def _pack(rows, pick):
    """A minibatch as flat (ids, cts, seg) over pick positions, and its
    nonempty real docs (the JAX package's ``pack``)."""
    n = len(rows)
    parts = [(rows[d][0], rows[d][1], np.full(len(rows[d][0]), pos, np.int32))
             for pos, d in enumerate(pick) if d < n]
    ids, cts, seg = (np.concatenate([p[i] for p in parts]) for i in range(3))
    return (ids.astype(np.int32), cts.astype(np.float32), seg,
            sum(1 for d in pick if d < n and len(rows[d][0])))


def _kw(k=K):
    return dict(alpha=torch.full((k,), 1.0 / k), eta=1.0 / k, tau0=TAU0,
                kappa=KAPPA)


def _jax_kw(k=K):
    return dict(alpha=np.full((k,), 1.0 / k, np.float32), eta=1.0 / k,
                tau0=TAU0, kappa=KAPPA, k=k, gamma_shape=SHAPE, seed=SEED)


# ---- the four iteration paths against their JAX runners ------------------
def test_flat_packed_iteration_matches_jax(tmp_path):
    """Three flat packed iterations (the port's CPU packed loop) against
    ``make_online_packed_chunk``: lambda within rtol 1e-4."""
    rows, vocab = _skewed()
    n, v = len(rows), len(vocab)
    lam0 = _lam0(tmp_path, K, v)
    picks = _picks(n, 14)
    packs = [_pack(rows, pk) for pk in picks]
    t_pad = next_pow2(max(p[0].size for p in packs))
    tok = np.zeros((3, 3, t_pad), np.float32)
    for j, (ids, cts, seg, _) in enumerate(packs):
        tok[0, j, : ids.size], tok[1, j, : ids.size] = ids, cts
        tok[2, j, : ids.size] = seg
    mesh = _mesh()
    run = make_online_packed_chunk(mesh, **_jax_kw())
    tok_spec = NamedSharding(mesh, P(None, "data"))
    want = run(TrainState(jnp.asarray(lam0), jnp.asarray(0, jnp.int32)),
               jax.device_put(tok[0].astype(np.int32), tok_spec),
               jax.device_put(tok[1], tok_spec),
               jax.device_put(tok[2].astype(np.int32), tok_spec),
               jnp.asarray(picks),
               jnp.asarray([p[3] for p in packs], jnp.float32), float(n))
    lam = torch.from_numpy(lam0)
    for step, (ids, cts, seg, docs) in enumerate(packs):
        lam = packed_iteration(
            lam, step, torch.from_numpy(ids), torch.from_numpy(cts),
            torch.from_numpy(seg),
            torch.from_numpy(_jax_gamma0(step, picks[step])), docs,
            corpus_size=float(n), **_kw())
    assert int(want.step) == 3
    np.testing.assert_allclose(lam.numpy(), np.asarray(want.lam), rtol=1e-4)


def test_uniform_tile_plan_matches_jax():
    """The chunk planner cuts minibatches (pad picks included) into the
    JAX package's tiles, geometry and all: with few pads, with 280 pads in
    one tile (d=512), with the doc cap splitting them (k=1300: 256 docs a
    tile), and with no geometry at all (k=1500)."""
    rows, _ = _skewed(n_docs=600)
    rng = np.random.default_rng(2)
    for real, pads, k, d in ((37, 3, K, 128), (20, 280, K, 512),
                             (20, 280, 1300, 256), (20, 280, 1500, None)):
        picks = np.stack([np.concatenate([
            rng.choice(len(rows), size=real, replace=False),
            np.arange(len(rows), len(rows) + pads)]) for _ in range(2)])
        packs = [_pack(rows, pk)[:3] for pk in picks]
        got = plan_tile_pack_uniform(packs, b=real + pads, tile_tokens=512,
                                     k=k)
        want = j_plan_tile_pack_uniform(packs, b=real + pads,
                                        tile_tokens=512, k=k)
        if d is None:
            assert got is None and want is None
            continue
        assert (got.tt, got.d, got.n_tiles, got.b) == (
            want.tt, want.d, want.n_tiles, want.b)
        assert got.d == d
        for name in ("ids", "cts", "seg", "doc_ids"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_packed_tiles_iteration_matches_jax(tmp_path):
    """Three host-streaming tiles iterations (the card's packed loop, the
    tile kernel's plain version here) against
    ``make_online_packed_tiles_chunk`` running the Pallas kernel in
    interpret mode: lambda within rtol 1e-4."""
    rows, vocab = _skewed()
    n, v = len(rows), len(vocab)
    lam0 = _lam0(tmp_path, K, v)
    picks = _picks(n, 40)
    packs = [_pack(rows, pk) for pk in picks]
    plan = plan_tile_pack_uniform([p[:3] for p in packs], b=40,
                                  tile_tokens=512, k=K)
    assert plan.n_tiles >= 2 and (plan.doc_ids[:, :, 0] == 40).any()
    mesh = _mesh()
    run = make_online_packed_tiles_chunk(
        mesh, **_jax_kw(), d=plan.d, interpret=True, gamma_backend="pallas")
    spec = NamedSharding(mesh, P(None, "data", None))
    want = run(TrainState(jnp.asarray(lam0), jnp.asarray(0, jnp.int32)),
               *(jax.device_put(a, spec)
                 for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids)),
               jnp.asarray(picks),
               jnp.asarray([p[3] for p in packs], jnp.float32), float(n))
    lam = torch.from_numpy(lam0)
    for step in range(3):
        g0 = docs_gamma_to_tiles(
            torch.from_numpy(_jax_gamma0(step, picks[step])),
            torch.from_numpy(plan.doc_ids[step]))
        lam = tiles_iteration(
            lam, step, torch.from_numpy(plan.ids[step]),
            torch.from_numpy(plan.cts[step]),
            torch.from_numpy(plan.seg[step]), g0, packs[step][3], d=plan.d,
            corpus_size=float(n), **_kw())
    assert int(want.step) == 3
    np.testing.assert_allclose(lam.numpy(), np.asarray(want.lam), rtol=1e-4)


def test_padded_resident_iteration_matches_jax(tmp_path, monkeypatch):
    """Three padded resident iterations against
    ``make_online_resident_chunk`` with the JAX E-step kernel (per-tile
    stop, interpret mode): lambda within rtol 1e-4.  13 picks: one full
    tile of 8 and one of 5 padded to 8; pad picks read the all-zero row."""
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    rows, vocab = _skewed(n_docs=60)
    n, v = len(rows), len(vocab)
    lam0 = _lam0(tmp_path, K, v)
    row_len = max(8, next_pow2(max(len(i) for i, _ in rows)))
    picks = _picks(n, 13)
    jb = j_batch_from_rows(rows, row_len=row_len)
    mesh = _mesh()
    run = make_online_resident_chunk(mesh, **_jax_kw())
    spec = NamedSharding(mesh, P("data", None))
    want = run(TrainState(jnp.asarray(lam0), jnp.asarray(0, jnp.int32)),
               jax.device_put(jb.token_ids, spec),
               jax.device_put(jb.token_weights, spec), jnp.asarray(picks),
               float(n))
    res = batch_from_rows(rows + [(np.zeros(0, np.int32),
                                   np.zeros(0, np.float32))], row_len=row_len)
    lam = torch.from_numpy(lam0)
    for step, pick in enumerate(picks):
        sel = torch.from_numpy(np.minimum(pick, n)).long()
        ids, wts = res.token_ids[sel], res.token_weights[sel]
        lam = padded_iteration(
            lam, step, ids, wts, torch.from_numpy(_jax_gamma0(step, pick)),
            int((wts.sum(-1) > 0).sum()), corpus_size=float(n), **_kw())
    assert int(want.step) == 3
    np.testing.assert_allclose(lam.numpy(), np.asarray(want.lam), rtol=1e-4)


def test_padded_host_iteration_matches_jax(tmp_path, monkeypatch):
    """Three host-path iterations of one minibatch (pow2 length buckets,
    each padded to a pow2 doc count, one M-step) against ``make_online_eb`` / ``estep`` /
    ``mstep`` with the JAX E-step kernel: lambda within rtol 1e-4."""
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    rows, vocab = _skewed(n_docs=60)
    n, v = len(rows), len(vocab)
    lam0 = _lam0(tmp_path, K, v)
    mesh = _mesh()
    eb_fn = make_online_eb(mesh)
    estep_fn = make_online_estep(mesh, alpha=np.full((K,), 1.0 / K,
                                                     np.float32))
    mstep_fn = make_online_mstep(mesh, eta=1.0 / K, tau0=TAU0, kappa=KAPPA)
    jlam, lam = jnp.asarray(lam0), torch.from_numpy(lam0)
    pick = np.random.default_rng(4).choice(n, size=11, replace=False)
    groups: dict = {}
    for i in pick:
        groups.setdefault(max(8, next_pow2(len(rows[i][0]))), []).append(i)
    assert len(groups) >= 2
    for it in range(3):
        jeb = eb_fn(jlam)
        eb = torch.exp(torch.digamma(lam) - torch.digamma(
            lam.sum(1, keepdim=True)))
        js, jc, sstats, docs = None, None, torch.zeros_like(lam), 0
        for width, idxs in sorted(groups.items()):
            b_pad = next_pow2(len(idxs))
            doc_ids = np.asarray(idxs + list(range(n, n + b_pad - len(idxs))),
                                 np.int32)
            g0 = _jax_gamma0(it, doc_ids)
            jb = j_batch_from_rows([rows[i] for i in idxs],
                                   row_len=width).pad_rows_to(b_pad)
            s, c = estep_fn(jeb, JDocTermBatch(jb.token_ids, jb.token_weights),
                            jnp.asarray(g0))
            js, jc = (s, c) if js is None else (js + s, jc + c)
            tb = batch_from_rows([rows[i] for i in idxs], row_len=width)
            pad = b_pad - len(idxs)
            ids = torch.cat([tb.token_ids, tb.token_ids.new_zeros(pad, width)])
            wts = torch.cat([tb.token_weights,
                             tb.token_weights.new_zeros(pad, width)])
            sstats += padded_estep(eb, ids, wts, torch.from_numpy(g0),
                                   alpha=torch.full((K,), 1.0 / K))
            docs += int((wts.sum(-1) > 0).sum())
        assert docs == int(jc)
        jlam = mstep_fn(jlam, jeb, js, jc, it, float(n))
        lam = padded_mstep(lam, eb, sstats, it, docs, eta=1.0 / K, tau0=TAU0,
                           kappa=KAPPA, corpus_size=float(n))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-4)


# ---- the sample stream and the decisions ---------------------------------
@pytest.mark.parametrize("sampling", ["fixed", "bernoulli", "epoch"])
def test_sample_pick_matches_jax(sampling):
    """``sample_pick`` is bit-equal to the JAX package's over two epochs'
    worth of iterations (the fits run no iteration)."""
    rows, vocab = _skewed(n_docs=90)
    kw = dict(k=K, algorithm="online", max_iterations=0, sampling=sampling,
              seed=3)
    jopt = JOnlineLDA(JParams(**kw), mesh=_mesh())
    jopt.fit(rows, vocab)
    topt = OnlineLDA(Params(**kw), device="cpu")
    topt.fit(rows, vocab)
    assert topt.last_batch_size == jopt.last_batch_size
    iters = 2 * -(-len(rows) // jopt.last_batch_size)
    for it in range(iters):
        got, want = topt.sample_pick(it), jopt.sample_pick(it)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# (corpus, sampling, token_layout, device_resident, over budget)
DECISIONS = [
    ("skewed", "fixed", "padded", True, False),
    ("skewed", "fixed", "padded", False, False),
    ("skewed", "fixed", "padded", "auto", True),
    ("skewed", "fixed", "packed", "auto", False),
    ("skewed", "fixed", "auto", True, False),
    ("skewed", "fixed", "auto", "auto", False),
    ("skewed", "bernoulli", "padded", "auto", False),
    ("skewed", "bernoulli", "packed", False, False),
    ("skewed", "bernoulli", "auto", False, False),
    ("skewed", "bernoulli", "auto", True, True),
    ("skewed", "epoch", "tiles", "auto", False),
    ("skewed", "epoch", "tiles", "auto", True),
    ("skewed", "epoch", "tiles", False, False),
    ("skewed", "epoch", "auto", "auto", False),
    ("skewed", "epoch", "auto", True, False),
    ("skewed", "epoch", "padded", False, False),
    ("even", "bernoulli", "auto", "auto", False),
    ("even", "bernoulli", "auto", "auto", True),
    ("even", "epoch", "auto", False, False),
    ("even", "fixed", "auto", True, True),
]


@pytest.mark.parametrize("corpus,sampling,layout,resident,over", DECISIONS,
                         ids=["-".join(map(str, c)) for c in DECISIONS])
def test_layout_decision_matches_jax(corpus, sampling, layout, resident,
                                     over):
    """One iteration of each package on the CPU: the same path, row
    length, batch size, gamma loop and tile geometry.  On the padded
    paths the JAX package names no gamma loop (it keeps its initial
    "xla"); the port names the E-step kernel it runs there."""
    rows, vocab = _skewed(n_docs=60) if corpus == "skewed" else _even()
    kw = dict(k=K, algorithm="online", max_iterations=1, sampling=sampling,
              token_layout=layout, device_resident=resident, seed=1)
    if over:
        kw["resident_budget_bytes"] = 16
    jopt = JOnlineLDA(JParams(**kw), mesh=_mesh())
    jopt.fit(rows, vocab)
    topt = OnlineLDA(Params(**kw), device="cpu")
    model = topt.fit(rows, vocab)
    assert (topt.last_layout, topt.last_row_len, topt.last_batch_size) == (
        jopt.last_layout, jopt.last_row_len, jopt.last_batch_size)
    if topt.last_layout == "padded":
        assert topt.last_gamma_backend == "pallas"
    else:
        assert topt.last_gamma_backend == jopt.last_gamma_backend
        assert topt.last_batch_cells == jopt.last_batch_cells
    if topt.last_layout == "tiles_resident":
        assert topt.last_tiles == jopt.last_tiles
    assert model.step == 1 and np.isfinite(model.lam).all()


@pytest.mark.parametrize("corpus", ["skewed_2000", "newsgroups_1542"])
def test_auto_decision_on_cpu_matches_jax(corpus):
    """Fault O1: under token_layout="auto" and sampling="epoch" the CPU
    follows the JAX package's non-TPU rule (tiles planned with a 1-doc
    floor; tiles declined past 3n doc slots).  On 2,000 skewed docs both
    run the tiles path with d=64; on the first 1,542 docs of config C's
    corpus (the fewest whose tiles trip the 3n guard) both leave it for
    the packed path."""
    if corpus == "skewed_2000":
        rows, vocab = _skewed(n_docs=2000)
        k = K
    else:
        rows = chip_smoke.newsgroups_rows(0)[:1542]
        vocab, k = [f"h{i}" for i in range(chip_smoke.NG_V)], chip_smoke.NG_K
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
        plan = plan_corpus_tiles(np.concatenate([i for i, _ in rows]),
                                 np.concatenate([w for _, w in rows]),
                                 offsets, k=k, min_tile_docs=1)
        assert plan.ids.shape[0] * plan.d > 3 * len(rows)
    kw = dict(k=k, algorithm="online", max_iterations=1, sampling="epoch",
              token_layout="auto", seed=0)
    jopt = JOnlineLDA(JParams(**kw), mesh=_mesh())
    jopt.fit(rows, vocab)
    topt = OnlineLDA(Params(**kw), device="cpu")
    topt.fit(rows, vocab)
    assert topt.last_layout == jopt.last_layout
    assert topt.last_batch_size == jopt.last_batch_size
    assert topt.last_gamma_backend == jopt.last_gamma_backend
    if corpus == "skewed_2000":
        assert topt.last_layout == "tiles_resident"
        assert topt.last_tiles == jopt.last_tiles and topt.last_tiles["d"] == 64
    else:
        assert topt.last_layout == "packed"
        assert topt.last_tiles is None


def test_card_rule_plans_tiles_on_the_cpu():
    """``rule="card"`` on the CPU takes the card's decisions: the tiles
    path with the 128-doc floor and no 3n guard, and the packed path on
    the tile kernel (its plain version here)."""
    rows, vocab = _skewed(n_docs=2000)
    kw = dict(k=K, algorithm="online", max_iterations=1, sampling="epoch")
    opt = OnlineLDA(Params(**kw), device="cpu", rule="card")
    opt.fit(rows, vocab)
    assert opt.last_layout == "tiles_resident"
    assert opt.last_gamma_backend == "pallas_tiles"
    assert opt.last_tiles["d"] == 128
    opt = OnlineLDA(Params(**dict(kw, sampling="bernoulli")), device="cpu",
                    rule="card")
    opt.fit(rows, vocab)
    assert (opt.last_layout, opt.last_gamma_backend) == (
        "packed", "pallas_tiles")
    (chunk,) = opt.last_tile_chunks
    assert chunk["d"] >= 128 and chunk["n_tiles"] == next_pow2(
        chunk["n_tiles"])
    with pytest.raises(ValueError, match="rule"):
        OnlineLDA(Params(**kw), device="cpu", rule="tpu")


# ---- the port's own paths against each other -----------------------------
def _fit(rows, vocab, **over):
    base = dict(k=4, algorithm="online", max_iterations=6, seed=0)
    base.update(over)
    return OnlineLDA(Params(**base), device="cpu").fit(rows, vocab)


def test_paths_train_to_the_same_model():
    """Packed (flat), padded-resident and padded-host fits from one seed
    draw the same minibatches and inits and agree within the JAX
    package's own band, rtol 5e-3 atol 1e-5 (tests/test_resident_training
    .py); the tiled packed loop (the card's rule) too."""
    rows, vocab = _rows(40, 3, lambda r: r.integers(5, 60))
    packed = _fit(rows, vocab, token_layout="packed")
    resident = _fit(rows, vocab, token_layout="padded", device_resident=True)
    host = _fit(rows, vocab, token_layout="padded", device_resident=False)
    tiles = OnlineLDA(Params(k=4, algorithm="online", max_iterations=6,
                             seed=0, token_layout="packed"),
                      device="cpu", rule="card").fit(rows, vocab)
    for other in (resident, host, tiles):
        np.testing.assert_allclose(other.lam, packed.lam, rtol=5e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("layout,resident", [
    ("packed", "auto"), ("padded", True), ("padded", False)],
    ids=["packed", "padded_resident", "padded_host"])
def test_resume_matches_uninterrupted(tmp_path, layout, resident):
    """A fit checkpointed at iteration 3 and resumed to 6 ends at the
    lambda of an uninterrupted 6-iteration fit, within rtol 1e-4 (the
    JAX package's band)."""
    rows, vocab = _rows(40, 3, lambda r: r.integers(5, 60))
    kw = dict(token_layout=layout, device_resident=resident)
    full = _fit(rows, vocab, **kw)
    ck = str(tmp_path / "ck")
    part = _fit(rows, vocab, **kw, checkpoint_dir=ck, checkpoint_interval=3,
                max_iterations=3)
    assert part.step == 3
    assert load_train_state(os.path.join(ck, "train_state.npz"))["step"] == 3
    resumed = _fit(rows, vocab, **kw, checkpoint_dir=ck,
                   checkpoint_interval=3)
    assert resumed.step == 6
    np.testing.assert_allclose(resumed.lam, full.lam, rtol=1e-4, atol=1e-6)


def test_empty_bernoulli_draw_skips_the_update(tmp_path):
    """A Bernoulli draw with no doc leaves lambda as it is, and the host
    path still writes its checkpoint on the cadence."""
    rows, vocab = _even(n_docs=3)
    kw = dict(k=3, algorithm="online", batch_size=0, sampling="bernoulli",
              seed=0, token_layout="padded", device_resident=False,
              max_iterations=2, checkpoint_dir=str(tmp_path),
              checkpoint_interval=2)
    opt = OnlineLDA(Params(**kw), device="cpu")
    model = opt.fit(rows, vocab)
    assert [opt.sample_pick(i).size for i in range(2)] == [0, 0]
    start = OnlineLDA(Params(**dict(kw, max_iterations=0,
                                    checkpoint_dir=None)),
                      device="cpu").fit(rows, vocab)
    np.testing.assert_array_equal(model.lam, start.lam)
    assert load_train_state(str(tmp_path / "train_state.npz"))["step"] == 2


def test_default_fit_matches_jax_quality():
    """The defaults (bernoulli sampling, "auto": the padded resident path
    on this corpus, 50 iterations) of each package from its own draws:
    both recover the two planted topics, and their log-perplexities agree
    within 3%."""
    rows, vocab = _planted()
    kw = dict(k=2, algorithm="online", seed=0)
    jopt = JOnlineLDA(JParams(**kw), mesh=_mesh())
    jmodel = jopt.fit(rows, vocab)
    topt = OnlineLDA(Params(**kw), device="cpu")
    tmodel = topt.fit(rows, vocab)
    assert topt.last_layout == jopt.last_layout == "padded"
    assert tmodel.step == 50
    v = len(vocab)
    for model in (tmodel, jmodel):
        lo_mass = model.topics_matrix()[:, : v // 2].sum(axis=1)
        assert (lo_mass > 0.85).any() and (lo_mass < 0.15).any()
    lp_t = tmodel.log_perplexity(rows, device="cpu")
    lp_j = jmodel.log_perplexity(rows)
    assert abs(lp_t - lp_j) / abs(lp_j) < 0.03
