"""Registered entry points for the trace audit (layer 2; layer 3 to come).

Every callable the production code paths dispatch — the EM/Online-VB/NMF
chunk and step functions, the kernel wrappers in ``ops/``, the sharded
scoring/eval paths and the scoring and serving calls — is registered
here with a builder that returns ``(fn, representative args)``.  Shapes
are TINY (k=4, V=64, B=8, L=8, T=32, the JAX package's audit geometry):
the audit calls each entry once on the CPU, so shapes need to be
representative in RANK and DTYPE, not size.

The registry holds all twenty of the JAX package's names, each with its
``multichip`` flag, bound to the port's counterpart: the callable that
``telemetry.instrument_dispatch`` wraps under the JAX entry's dispatch
label, or where none does, the nearest callable doing the same work (a
comment says why).  Then one entry per dispatch label that no JAX name
covers, under the port's label.  ``ENTRY_LABELS`` maps every entry to the
dispatch labels it covers; the self-tests prove that every label passed
to ``instrument_dispatch`` in the package is covered
(``ast_rules.dispatch_labels``).

A ``multichip`` entry runs on a 1x1 ``ProcessGrid`` (``make_grid(1, 1,
device="cpu")``, which needs no process group): the fits keep a 1x1 grid
as ``None``, so the audit hands the grid to the code itself, and the
grid branch, collectives included, runs at one rank.

The three kernel entries (``ops.pallas_estep.gamma_fixed_point_bkl``,
``ops.pallas_packed.gamma_fixed_point_tiles``,
``ops.pallas_nmf.mu_update_tiles``) bind the wrappers ``ops.estep
.gamma_fixed_point_bkl``, ``ops.packed.gamma_fixed_point_tiles`` and
``ops.nmf.nmf_mu_update_tiles``; on CPU tensors these run their plain
versions.  The audit covers each wrapper and its plain version;
``chip_smoke.py`` covers the kernels on the card.

Every input tensor is made on the CPU, with an explicit dtype, from a
fixed ``torch.Generator``.

Each registration also declares its **scale shapes** (``ScaleSpec``, the
JAX package's type): the CC-News geometry (k=500, V=10M, the pow2 bucket
grids) that the scale audit (layer 3, ``analysis.scale_audit``, STC210-
215) calls the entry at, on fake tensors.  A scale builder ``build(dims)``
mirrors the toy builder at the dims' values and returns the same
callable; it runs under the audit's ``FakeTensorMode``, so every tensor
it makes (``_sfake``, and what the fits' own layout code makes) is shape
and dtype only.  Host plans stay real numpy, built as the fit builds
them from real index arrays of the scale length.  A multichip entry runs
on ``scale_audit.audit_grid()``: rank 0 of a 1 x ``SCALE_MODEL_SHARDS``
grid with no process groups, so the code cuts the vocabulary as one card
of a 16-card row does and the trace sees per-card shapes.  A dim
declared ``bucketed=True`` promises a pow2 grid; ``sharded_dims`` names
the dims cut over the model axis at scale.  The JAX package's twenty
names keep its dims, ``sharded_dims`` and ``model_shards``; each
port-only entry takes the dims of the JAX sibling that covers the same
work (a comment names it).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "ENTRY_LABELS",
    "ENTRYPOINTS",
    "EntryPoint",
    "SCALE_K",
    "SCALE_MODEL_SHARDS",
    "SCALE_V",
    "ScaleDim",
    "ScaleSpec",
    "entrypoint_names",
]

# audit geometry — small, rank-faithful (the JAX package's)
K = 4          # topics
V = 64         # vocab (also the model-shard-padded width at 1 shard)
B = 8          # docs per batch
L = 8          # row length (distinct terms per doc)
T = 32         # packed token count
# tile geometry of the tiled entries (the JAX package's): 2 tiles of 16
# token slots and 4 doc slots each
_TILES, _TT, _D = 2, 16, 4
_SEED = 0

# scale geometry — the CC-News config (the JAX package's): k=500 topics
# over a 10M-term vocabulary.  A [k, V] float32 lambda is 20 GB, so the
# vocab-sharded entries declare 16 model shards (1.25 GB of lambda a
# card); batch and token dims ride the pow2 bucket grids.
SCALE_K = 500
SCALE_V = 10_000_000
SCALE_MODEL_SHARDS = 16
_SCALE_B = (512, 1024)          # docs per trigger, pow2-bucketed
_SCALE_L = (128, 256)           # distinct terms per doc, pow2-bucketed
_SCALE_T = (1 << 14, 1 << 15)   # packed token count, pow2-bucketed
_SCALE_TILES = (64, 128)        # resident tile count, pow2-bucketed
_SCALE_TT = 256                 # tokens per tile (static at scale)
_SCALE_D = 64                   # doc slots per tile (static at scale)
_SCALE_SERVE_T = (1024, 4096)   # serve token buckets (the server's grid)
_SCALE_CORPUS = (1_000_000, 1_000_000_000)


@dataclass(frozen=True)
class ScaleDim:
    """One declared scale dimension: the grid of values the entry is
    dispatched at in production, and whether that grid is a bounded
    pow2 bucket set (``bucketed=True``) or a single static point."""

    points: Tuple[int, ...]
    bucketed: bool = False


@dataclass(frozen=True)
class ScaleSpec:
    """Declared scale geometry for one entry point (layer-3 audit).

    ``build(dims)`` mirrors the toy builder but receives the dim-value
    mapping and returns ``(fn, args)`` whose tensor leaves are fake (made
    under ``scale_audit.fake_mode()``): no buffers.  ``kernel_io``, on a
    kernel's entries: fn(*args) -> the kernel module's ``cost()`` bytes
    at the scale point, which the record carries beside the plain
    version's peak.  ``steps``: the steps (sweeps, iterations) one call
    runs, a chunk runner's ``m``; the collective budget is a step's."""

    dims: Mapping[str, ScaleDim]
    build: Callable[[Dict[str, int]], Tuple[Callable, Sequence]]
    sharded_dims: Tuple[str, ...] = ()
    model_shards: int = SCALE_MODEL_SHARDS
    collective_budget_bytes: Optional[int] = None
    note: str = ""
    kernel_io: Optional[Callable[..., int]] = None
    steps: int = 1


@dataclass(frozen=True)
class EntryPoint:
    name: str                      # dotted id used in reports/baselines
    multichip: bool                # must issue a collective on a grid
    build: Callable[[], Tuple[Callable, Sequence]]
    scale: Optional[ScaleSpec] = field(default=None, compare=False)


# ---------------------------------------------------------------------------
# toy inputs
# ---------------------------------------------------------------------------
def _gen():
    import torch

    return torch.Generator().manual_seed(_SEED)


def _cpu():
    import torch

    return torch.device("cpu")


def _grid():
    from ..parallel.mesh import make_grid

    return make_grid(1, 1, device="cpu")


def _f32(gen, *shape, low: float = 0.5):
    """Positive float32 values in [low, low + 1)."""
    import torch

    return torch.rand(shape, generator=gen, dtype=torch.float32) + low


def _alpha():
    import torch

    return torch.full((K,), 0.1, dtype=torch.float32)


def _rows(gen, n: int = B, nnz: int = L):
    """``n`` host rows (ids int32, weights float32) of ``nnz`` distinct
    terms each, as the fits take them."""
    import torch

    rows = []
    for _ in range(n):
        ids = torch.randperm(V, generator=gen)[:nnz].sort().values
        wts = torch.rand(nnz, generator=gen, dtype=torch.float32) + 0.5
        rows.append((ids.to(torch.int32).numpy(), wts.numpy()))
    return rows


def _batch(gen):
    from ..ops.sparse import batch_from_rows

    return batch_from_rows(_rows(gen), row_len=L, device="cpu")


def _tiles(gen):
    """(ids, cts, seg) [tiles, tt] of a tile plan: each tile's 16 slots
    hold 4 docs of 3 tokens, then pad slots (seg == d, cts == 0)."""
    import torch

    ids = torch.randint(0, V, (_TILES, _TT), generator=gen,
                        dtype=torch.int32)
    seg = torch.full((_TILES, _TT), _D, dtype=torch.int32)
    seg[:, :3 * _D] = torch.arange(_D, dtype=torch.int32).repeat_interleave(3)
    cts = torch.where(seg < _D, _f32(gen, _TILES, _TT),
                      torch.zeros((), dtype=torch.float32))
    return ids, cts, seg


def _online_kw():
    return dict(alpha=_alpha(), eta=0.01, tau0=1024.0, kappa=0.51,
                corpus_size=1000.0, max_inner=5, tol=1e-3)


def _gamma_rows():
    from ..models.online_lda import make_gamma_rows

    return make_gamma_rows(seed=_SEED, n=B, k=K, gamma_shape=100.0,
                           rng_device=_cpu(), device=_cpu())


def _em(grid):
    """An EM estimator whose layouts run on ``grid`` (a 1x1 grid: the
    fit keeps one as None), and its priors."""
    from ..config import Params
    from ..models.em_lda import EMLDA

    est = EMLDA(Params(k=K, algorithm="em"), device="cpu")
    est.grid = grid
    return est, est.params.resolved_alpha(), est.params.resolved_eta()


def _em_counts(gen, layout, n: int = B):
    """(n_wk, n_dk) as ``layout`` holds them, from positive counts."""
    return layout.put(_f32(gen, K, V).numpy(), _f32(gen, n, K).numpy())


# ---------------------------------------------------------------------------
# builders: the JAX package's names
# ---------------------------------------------------------------------------
def _build_em_padded_chunk(m: int):
    from ..models.em_lda import make_em_chunk_runner

    gen = _gen()
    est, alpha, eta = _em(_grid())
    layout = est._padded_grid(_rows(gen), V, V, K, alpha, eta)
    return make_em_chunk_runner(layout.sweep), (*_em_counts(gen, layout), m)


def _build_em_bucket_step():
    # the verbose padded fit's dispatch ("em.bucket_step"): one sweep of
    # the padded layout's buckets a call
    return _build_em_padded_chunk(1)


def _build_em_train_step():
    # JAX dispatches no train step: its padded chunk runner
    # ("em.chunk_runner") scans make_em_train_step, and the port's runs
    # the padded layout's sweep m times, the nearest callable
    return _build_em_padded_chunk(2)


def _build_em_packed_loglik():
    gen = _gen()
    est, alpha, eta = _em(_grid())
    layout = est._packed_grid(_rows(gen), V, V, K, alpha, eta)
    return layout.loglik, _em_counts(gen, layout)


def _build_online_train_step():
    # JAX dispatches make_online_train_step as "stream.online_step": the
    # port's streaming step, one padded online-VB update
    import torch

    from ..streaming import _online_step

    gen = _gen()
    batch = _batch(gen)
    step_docs = torch.tensor([0, B], dtype=torch.int64)
    corpus = torch.tensor(1000.0, dtype=torch.float32)
    kw = _online_kw()
    del kw["corpus_size"]
    return functools.partial(_online_step, grid=_grid(), **kw), (
        _f32(gen, K, V), step_docs, batch.token_ids, batch.token_weights,
        _f32(gen, B, K), corpus)


def _build_online_estep():
    from ..models.online_lda import _estep_run

    gen = _gen()
    batch = _batch(gen)
    fn = functools.partial(_estep_run, alpha=_alpha(), max_inner=5,
                           tol=1e-3, grid=_grid())
    return fn, (_f32(gen, K, V), batch.token_ids, batch.token_weights,
                _f32(gen, B, K))


def _build_online_mstep():
    import torch

    from ..models.online_lda import _mstep_run

    gen = _gen()
    fn = functools.partial(_mstep_run, eta=0.01, tau0=1024.0, kappa=0.51,
                           corpus_size=1000.0)
    step_docs = torch.tensor([3, B], dtype=torch.int64)
    return fn, (_f32(gen, K, V), _f32(gen, K, V), _f32(gen, K, V),
                step_docs)


def _build_nmf_padded(m: int):
    from ..models.nmf import make_nmf_train_step

    gen = _gen()
    batch = _batch(gen)
    return make_nmf_train_step(_grid()), (
        _f32(gen, B, K), _f32(gen, K, V), batch.token_ids,
        batch.token_weights, m)


def _build_nmf_train_step():
    return _build_nmf_padded(1)


def _build_nmf_packed_chunk():
    import torch

    from ..models.nmf import make_nmf_packed_runner

    # flat layout (d=None): seg holds shard-local doc rows
    gen = _gen()
    ids = torch.randint(0, V, (T,), generator=gen, dtype=torch.int32)
    cts = _f32(gen, T)
    seg = torch.arange(B, dtype=torch.int32).repeat(T // B)
    fn = make_nmf_packed_runner(_grid(), x2=float((cts * cts).sum()))
    return fn, (_f32(gen, B, K), _f32(gen, K, V), ids, cts, seg, 2)


def _build_nmf_fused_chunk():
    from ..models.nmf import make_nmf_packed_runner

    # tiles layout: W in tile-slot order, the W side in the kernel
    # wrapper (its plain version on the CPU)
    gen = _gen()
    ids, cts, seg = _tiles(gen)
    fn = make_nmf_packed_runner(_grid(), x2=float((cts * cts).sum()), d=_D)
    return fn, (_f32(gen, _TILES * _D, K), _f32(gen, K, V), ids, cts, seg, 2)


def _build_nmf_solve_w():
    import torch

    from ..models.nmf import _solve_w_run

    gen = _gen()
    return _solve_w_run, (_f32(gen, B, K), _f32(gen, K, K),
                          torch.tensor(5, dtype=torch.int64))


def _build_pallas_nmf_mu_update():
    from ..ops.nmf import nmf_mu_update_tiles

    gen = _gen()
    _, cts, seg = _tiles(gen)
    fn = functools.partial(nmf_mu_update_tiles, d=_D, eps=1e-9)
    return fn, (_f32(gen, K, _TILES * _TT), cts, seg,
                _f32(gen, _TILES * _D, K), _f32(gen, K, K))


def _resident_tiles(gen):
    """This rank's resident tiles and their doc ids (pad slots == B)."""
    import torch

    ids, cts, seg = _tiles(gen)
    doc = torch.arange(_TILES * _D, dtype=torch.int32).reshape(_TILES, _D)
    return ids, cts, seg, doc


def _build_online_tiles_resident_chunk():
    import numpy as np

    from ..models.online_lda import (
        make_online_chunk_runner,
        make_online_tiles_resident_chunk,
    )

    # the card's rule (per_tile_stop: the tile kernel's wrapper, its plain
    # version here); the kernel wrapper is audited on its own too
    gen = _gen()
    ids, cts, seg, doc = _resident_tiles(gen)
    chunk = make_online_tiles_resident_chunk(
        ids, cts, seg, doc, doc.numpy(),
        lambda it: np.array([[it % _TILES, (it + 1) % _TILES]], np.int32),
        _gamma_rows(), n=B, d=_D, per_tile_stop=True, grid=_grid(),
        **_online_kw())
    import torch

    return make_online_chunk_runner(chunk), (
        _f32(gen, K, V), torch.tensor(0, dtype=torch.int64), 2)


def _build_sharded_topic_inference():
    import numpy as np

    from ..models.sharded_eval import make_sharded_topic_inference

    gen = _gen()
    batch = _batch(gen)
    fn = make_sharded_topic_inference(
        _grid(), alpha=np.full((K,), 0.1, np.float32), vocab_size=V,
        max_inner=5)
    return fn, (_f32(gen, K, V), batch.token_ids, batch.token_weights,
                _f32(gen, B, K))


def _build_sharded_log_likelihood():
    import numpy as np

    from ..models.sharded_eval import make_sharded_log_likelihood

    gen = _gen()
    batch = _batch(gen)
    fn = make_sharded_log_likelihood(
        _grid(), alpha=np.full((K,), 0.1, np.float32), eta=0.01,
        vocab_size=V, max_inner=5)
    return fn, (_f32(gen, K, V), batch.token_ids, batch.token_weights,
                _f32(gen, B, K), 1000.0, float(B))


def _build_sharded_em_log_likelihood():
    from ..models.sharded_eval import make_sharded_em_log_likelihood

    gen = _gen()
    batch = _batch(gen)
    fn = make_sharded_em_log_likelihood(_grid(), alpha=11.0, eta=1.1,
                                        vocab_size=V)
    return fn, (_f32(gen, K, V), _f32(gen, B, K), batch.token_ids,
                batch.token_weights)


def _build_pallas_estep_bkl():
    from ..ops.estep import gamma_fixed_point_bkl

    gen = _gen()
    fn = functools.partial(gamma_fixed_point_bkl, max_inner=5, tol=1e-3)
    return fn, (_f32(gen, B, K, L), _f32(gen, B, L), _alpha(),
                _f32(gen, B, K))


def _build_pallas_packed_tiles():
    from ..ops.packed import gamma_fixed_point_tiles

    gen = _gen()
    _, cts, seg = _tiles(gen)
    fn = functools.partial(gamma_fixed_point_tiles, d=_D, max_inner=5,
                           tol=1e-3)
    return fn, (_f32(gen, K, _TILES * _TT), cts, seg, _alpha(),
                _f32(gen, K, _TILES * _D))


def _build_lda_math_e_step():
    # JAX dispatches its padded E-step (e_step) through topic_inference
    # under "score.topic_inference": the port's scoring call, whose gamma
    # loop is the padded E-step (the kernel's wrapper on the card's rule)
    from ..models.base import topic_inference

    gen = _gen()
    fn = functools.partial(topic_inference, max_inner=5, tol=1e-3,
                           backend="pallas")
    return fn, (_batch(gen), _f32(gen, K, V), _alpha(), _f32(gen, B, K))


def _segments_args(gen):
    import torch

    from ..ops.segments import pack_offsets

    seg = torch.arange(B, dtype=torch.int32).repeat_interleave(T // B)
    offsets = torch.from_numpy(pack_offsets([T // B] * B))
    return (_f32(gen, T, K), _f32(gen, T), seg, _alpha(), _f32(gen, B, K)), \
        offsets


def _build_serve_topic_inference():
    # the scoring service's frozen (per-document convergence) packed
    # inference — serving-only code, so the audit sees THIS branch
    from ..serving.server import _infer

    gen = _gen()
    args, offsets = _segments_args(gen)
    fn = functools.partial(_infer, max_inner=5, freeze=True, offsets=offsets)
    return fn, args


def _build_score_gather():
    import torch

    from ..models.base import _gather

    gen = _gen()
    idx = torch.randint(0, V, (T,), generator=gen, dtype=torch.int64)
    return _gather, (_f32(gen, V, K), idx)


# ---------------------------------------------------------------------------
# builders: the port's dispatch labels that no JAX name covers
# ---------------------------------------------------------------------------
def _build_em_packed_chunk():
    from ..models.em_lda import make_em_chunk_runner

    gen = _gen()
    est, alpha, eta = _em(_grid())
    layout = est._packed_grid(_rows(gen), V, V, K, alpha, eta)
    return make_em_chunk_runner(layout.sweep), (*_em_counts(gen, layout), 2)


def _build_online_eb():
    from ..models.online_lda import _eb_run

    return _eb_run, (_f32(_gen(), K, V), _grid())


def _packs(gen, m: int = 2):
    """``m`` flat minibatches (ids, cts, seg, docs) over B positions and
    their picks [m, B]."""
    import numpy as np

    packs = []
    for _ in range(m):
        rows = _rows(gen, nnz=T // B)
        ids = np.concatenate([i for i, _ in rows])
        cts = np.concatenate([w for _, w in rows])
        seg = np.repeat(np.arange(B, dtype=np.int32), T // B)
        packs.append((ids, cts, seg, B))
    picks = np.tile(np.arange(B, dtype=np.int32), (m, 1))
    return picks, packs


def _build_online_packed_tiles_chunk():
    import torch

    from ..models.online_lda import (
        _packed_tiles_run,
        make_online_packed_tiles_chunk,
    )
    from ..ops.packed import plan_tile_pack_uniform

    gen = _gen()
    picks, packs = _packs(gen)
    plan = plan_tile_pack_uniform([pk[:3] for pk in packs], b=B, k=K)
    chunk = make_online_packed_tiles_chunk(
        _gamma_rows(), device=_cpu(), rng_device=_cpu(), grid=_grid(),
        **_online_kw())
    return _packed_tiles_run, (
        _f32(gen, K, V), torch.tensor(0, dtype=torch.int64), len(packs),
        lambda lam: chunk(lam, 0, picks, packs, plan))


def _build_online_packed_chunk():
    import torch

    from ..models.online_lda import _packed_flat_run, make_online_packed_chunk

    gen = _gen()
    picks, packs = _packs(gen)
    chunk = make_online_packed_chunk(
        _gamma_rows(), device=_cpu(), rng_device=_cpu(), grid=_grid(),
        **_online_kw())
    return _packed_flat_run, (
        _f32(gen, K, V), torch.tensor(0, dtype=torch.int64), len(packs),
        lambda lam: chunk(lam, 0, picks, packs))


def _build_online_resident(m: int):
    import numpy as np
    import torch

    from ..models.online_lda import (
        make_online_chunk_runner,
        make_online_resident_chunk,
    )

    gen = _gen()
    batch = _batch(gen)
    nonempty = np.ones(B + 1, bool)
    nonempty[B] = False
    chunk = make_online_resident_chunk(
        batch.token_ids, batch.token_weights, nonempty,
        lambda it: np.roll(np.arange(B, dtype=np.int32), it), _gamma_rows(),
        n=B, bsz=B, rng_device=_cpu(), grid=_grid(), **_online_kw())
    return make_online_chunk_runner(chunk), (
        _f32(gen, K, V), torch.tensor(0, dtype=torch.int64), m)


def _build_online_resident_chunk():
    return _build_online_resident(2)


def _build_online_resident_step():
    # the verbose padded-resident fit's dispatch: one iteration a call
    return _build_online_resident(1)


def _build_nmf_chunk_runner():
    return _build_nmf_padded(2)


def _build_nmf_loss():
    from ..models.nmf import _loss_run

    gen = _gen()
    fn = functools.partial(_loss_run, grid=_grid())
    return fn, (_batch(gen), _f32(gen, B, K), _f32(gen, K, V))


def _build_score_topic_inference_segments():
    # the scoring path's packed inference (batch convergence)
    from ..models.base import _segments

    gen = _gen()
    args, offsets = _segments_args(gen)
    fn = functools.partial(_segments, max_inner=5, offsets=offsets)
    return fn, args


# ---------------------------------------------------------------------------
# scale builders (layer 3): the toy builders' twins at a scale point.
# They run under the scale audit's fake mode: tensor leaves are fake, of
# the toy builder's dtypes; host plans are real numpy; scalars stay
# concrete (their VALUE is a scale param: STC215 traces the grid-min and
# grid-max points).
# ---------------------------------------------------------------------------
def _sfake(dtype, *shape):
    """A fake tensor of ``shape``: shape and dtype only."""
    import torch

    from .scale_audit import fake_mode

    with fake_mode():
        return torch.empty(shape, dtype=dtype)


def _sf32(*shape):
    import torch

    return _sfake(torch.float32, *shape)


def _si32(*shape):
    import torch

    return _sfake(torch.int32, *shape)


def _sgrid():
    from .scale_audit import audit_grid

    return audit_grid(SCALE_MODEL_SHARDS)


def _shard(v: int) -> int:
    """This card's vocabulary columns on the audit grid (V padded to the
    model shards, as the fits pad it)."""
    return -(-v // SCALE_MODEL_SHARDS)


def _salpha(k: int):
    import torch

    return _sfake(torch.float32, k)


def _srows(b: int, nnz: int, v: int):
    """``b`` real host rows of ``nnz`` distinct ids each, spread over the
    whole vocabulary (so every model shard owns some), weights 1."""
    import numpy as np

    step = max(1, v // nnz)
    base = np.arange(nnz, dtype=np.int64) * step
    ones = np.ones(nnz, np.float32)
    return [(np.sort((base + 7919 * j) % v).astype(np.int32), ones)
            for j in range(b)]


def _sbatch(b: int, l: int):
    from ..ops.sparse import DocTermBatch

    return DocTermBatch(_si32(b, l), _sf32(b, l))


def _sonline_kw(d):
    kw = _online_kw()
    kw["alpha"] = _salpha(d["k"])
    if "corpus" in d:
        kw["corpus_size"] = float(d["corpus"])
    return kw


def _sgamma_rows(n: int, k: int):
    from ..models.online_lda import make_gamma_rows

    return make_gamma_rows(seed=_SEED, n=n, k=k, gamma_shape=100.0,
                           rng_device=_cpu(), device=_cpu())


def _sem(d):
    from ..config import Params
    from ..models.em_lda import EMLDA

    est = EMLDA(Params(k=d["k"], algorithm="em"), device="cpu")
    est.grid = _sgrid()
    return est, est.params.resolved_alpha(), est.params.resolved_eta()


def _scale_em_padded_chunk(d, m: int):
    from ..models.em_lda import make_em_chunk_runner

    est, alpha, eta = _sem(d)
    v = d["v"]
    layout = est._padded_grid(_srows(d["b"], d["l"], v), v, v, d["k"],
                              alpha, eta)
    return make_em_chunk_runner(layout.sweep), (
        _sf32(d["k"], _shard(v)), _sf32(d["b"], d["k"]), m)


def _scale_em_bucket_step(d):
    return _scale_em_padded_chunk(d, 1)


def _scale_em_train_step(d):
    return _scale_em_padded_chunk(d, 2)


def _sem_packed(d):
    """The packed layout on the audit grid, from ``b`` docs of ``t / b``
    tokens each."""
    est, alpha, eta = _sem(d)
    v = d["v"]
    rows = _srows(d["b"], d["t"] // d["b"], v)
    return est._packed_grid(rows, v, v, d["k"], alpha, eta)


def _scale_em_packed_loglik(d):
    layout = _sem_packed(d)
    return layout.loglik, (_sf32(d["k"], _shard(d["v"])),
                           _sf32(d["b"], d["k"]))


def _scale_online_train_step(d):
    import torch

    from ..streaming import _online_step

    kw = _sonline_kw(d)
    del kw["corpus_size"]
    return functools.partial(_online_step, grid=_sgrid(), **kw), (
        _sf32(d["k"], _shard(d["v"])), _sfake(torch.int64, 2),
        _si32(d["b"], d["l"]), _sf32(d["b"], d["l"]), _sf32(d["b"], d["k"]),
        _sfake(torch.float32))


def _scale_online_estep(d):
    from ..models.online_lda import _estep_run

    fn = functools.partial(_estep_run, alpha=_salpha(d["k"]), max_inner=5,
                           tol=1e-3, grid=_sgrid())
    return fn, (_sf32(d["k"], _shard(d["v"])), _si32(d["b"], d["l"]),
                _sf32(d["b"], d["l"]), _sf32(d["b"], d["k"]))


def _scale_online_mstep(d):
    import torch

    from ..models.online_lda import _mstep_run

    # the M-step is elementwise on this card's vocabulary shard
    fn = functools.partial(_mstep_run, eta=0.01, tau0=1024.0, kappa=0.51,
                           corpus_size=float(d["corpus"]))
    w = _shard(d["v"])
    return fn, (_sf32(d["k"], w), _sf32(d["k"], w), _sf32(d["k"], w),
                _sfake(torch.int64, 2))


def _scale_nmf_padded(d, m: int):
    from ..models.nmf import make_nmf_train_step

    return make_nmf_train_step(_sgrid()), (
        _sf32(d["b"], d["k"]), _sf32(d["k"], _shard(d["v"])),
        _si32(d["b"], d["l"]), _sf32(d["b"], d["l"]), m)


def _scale_nmf_train_step(d):
    return _scale_nmf_padded(d, 1)


def _scale_nmf_packed_chunk(d):
    from ..models.nmf import make_nmf_packed_runner

    # flat layout (d=None); x2 is a host float, as the fit passes it
    fn = make_nmf_packed_runner(_sgrid(), x2=1.0)
    return fn, (_sf32(d["b"], d["k"]), _sf32(d["k"], _shard(d["v"])),
                _si32(d["t"]), _sf32(d["t"]), _si32(d["t"]), 2)


def _scale_nmf_fused_chunk(d):
    from ..models.nmf import make_nmf_packed_runner

    fn = make_nmf_packed_runner(_sgrid(), x2=1.0, d=d["d"])
    return fn, (_sf32(d["tiles"] * d["d"], d["k"]),
                _sf32(d["k"], _shard(d["v"])),
                _si32(d["tiles"], d["tt"]), _sf32(d["tiles"], d["tt"]),
                _si32(d["tiles"], d["tt"]), 2)


def _scale_nmf_solve_w(d):
    import torch

    from ..models.nmf import _solve_w_run

    # the port's transform takes X H^T [B, k] and H H^T [k, k], formed by
    # its caller: no V-wide operand reaches it
    return _solve_w_run, (_sf32(d["b"], d["k"]), _sf32(d["k"], d["k"]),
                          _sfake(torch.int64))


def _scale_pallas_nmf_mu_update(d):
    from ..ops.nmf import nmf_mu_update_tiles

    fn = functools.partial(nmf_mu_update_tiles, d=d["d"], eps=1e-9)
    t = d["tiles"] * d["tt"]
    return fn, (_sf32(d["k"], t), _sf32(d["tiles"], d["tt"]),
                _si32(d["tiles"], d["tt"]), _sf32(d["tiles"] * d["d"], d["k"]),
                _sf32(d["k"], d["k"]))


def _scale_online_tiles_resident_chunk(d):
    import numpy as np
    import torch

    from ..models.online_lda import (
        make_online_chunk_runner,
        make_online_tiles_resident_chunk,
    )

    # the JAX builder's picks: one tile a minibatch, 2 iterations a chunk
    tiles, dd = d["tiles"], d["d"]
    n = tiles * dd
    doc_ids = np.arange(n, dtype=np.int32).reshape(tiles, dd)
    chunk = make_online_tiles_resident_chunk(
        _si32(tiles, d["tt"]), _sf32(tiles, d["tt"]), _si32(tiles, d["tt"]),
        _si32(tiles, dd), doc_ids,
        lambda it: np.array([[it % tiles]], np.int32),
        _sgamma_rows(n, d["k"]), n=n, d=dd, per_tile_stop=True,
        grid=_sgrid(), **_sonline_kw(d))
    return make_online_chunk_runner(chunk), (
        _sf32(d["k"], _shard(d["v"])), _sfake(torch.int64), 2)


def _scale_sharded_topic_inference(d):
    import numpy as np

    from ..models.sharded_eval import make_sharded_topic_inference

    fn = make_sharded_topic_inference(
        _sgrid(), alpha=np.full((d["k"],), 0.1, np.float32),
        vocab_size=d["v"], max_inner=5)
    return fn, (_sf32(d["k"], _shard(d["v"])), _si32(d["b"], d["l"]),
                _sf32(d["b"], d["l"]), _sf32(d["b"], d["k"]))


def _scale_sharded_log_likelihood(d):
    import numpy as np

    from ..models.sharded_eval import make_sharded_log_likelihood

    fn = make_sharded_log_likelihood(
        _sgrid(), alpha=np.full((d["k"],), 0.1, np.float32), eta=0.01,
        vocab_size=d["v"], max_inner=5)
    return fn, (_sf32(d["k"], _shard(d["v"])), _si32(d["b"], d["l"]),
                _sf32(d["b"], d["l"]), _sf32(d["b"], d["k"]),
                float(d["corpus"]), float(d["b"]))


def _scale_sharded_em_log_likelihood(d):
    from ..models.sharded_eval import make_sharded_em_log_likelihood

    fn = make_sharded_em_log_likelihood(_sgrid(), alpha=11.0, eta=1.1,
                                        vocab_size=d["v"])
    return fn, (_sf32(d["k"], _shard(d["v"])), _sf32(d["b"], d["k"]),
                _si32(d["b"], d["l"]), _sf32(d["b"], d["l"]))


def _scale_pallas_estep_bkl(d):
    from ..ops.estep import gamma_fixed_point_bkl

    fn = functools.partial(gamma_fixed_point_bkl, max_inner=5, tol=1e-3)
    return fn, (_sf32(d["b"], d["k"], d["l"]), _sf32(d["b"], d["l"]),
                _salpha(d["k"]), _sf32(d["b"], d["k"]))


def _scale_pallas_packed_tiles(d):
    from ..ops.packed import gamma_fixed_point_tiles

    fn = functools.partial(gamma_fixed_point_tiles, d=d["d"], max_inner=5,
                           tol=1e-3)
    return fn, (_sf32(d["k"], d["tiles"] * d["tt"]),
                _sf32(d["tiles"], d["tt"]), _si32(d["tiles"], d["tt"]),
                _salpha(d["k"]), _sf32(d["k"], d["tiles"] * d["d"]))


def _scale_lda_math_e_step(d):
    from ..models.base import topic_inference

    fn = functools.partial(topic_inference, max_inner=5, tol=1e-3,
                           backend="pallas")
    return fn, (_sbatch(d["b"], d["l"]), _sf32(d["k"], d["v"]),
                _salpha(d["k"]), _sf32(d["b"], d["k"]))


def _ssegments(d):
    """(eb_tok, cts, seg, alpha, gamma0) of ``b`` contiguous docs over
    ``t`` token slots, and their offsets (a real host plan)."""
    import numpy as np
    import torch

    from ..ops.segments import pack_offsets

    # under the fake mode from_numpy keeps the shape: the CPU path reads
    # seg, the card's kernel the offsets
    offsets = torch.from_numpy(pack_offsets(np.full(d["b"], d["t"] // d["b"])))
    return (_sf32(d["t"], d["k"]), _sf32(d["t"]), _si32(d["t"]),
            _salpha(d["k"]), _sf32(d["b"], d["k"])), offsets


def _scale_serve_topic_inference(d):
    from ..serving.server import _infer

    args, offsets = _ssegments(d)
    fn = functools.partial(_infer, max_inner=5, freeze=True, offsets=offsets)
    return fn, args


def _scale_score_gather(d):
    import torch

    from ..models.base import _gather

    return _gather, (_sf32(d["v"], d["k"]), _sfake(torch.int64, d["t"]))


def _scale_em_packed_chunk(d):
    from ..models.em_lda import make_em_chunk_runner

    layout = _sem_packed(d)
    return make_em_chunk_runner(layout.sweep), (
        _sf32(d["k"], _shard(d["v"])), _sf32(d["b"], d["k"]), 2)


def _scale_online_eb(d):
    from ..models.online_lda import _eb_run

    return _eb_run, (_sf32(d["k"], _shard(d["v"])), _sgrid())


def _spacks(d, m: int = 2):
    """``m`` real flat minibatches of ``b`` docs of ``t / b`` tokens each,
    and their picks [m, b]."""
    import numpy as np

    b = d["b"]
    per = d["t"] // b
    packs = []
    for j in range(m):
        rows = _srows(b, per, d["v"])
        ids = np.concatenate([i for i, _ in rows])
        cts = np.concatenate([w for _, w in rows])
        seg = np.repeat(np.arange(b, dtype=np.int32), per)
        packs.append((ids, cts, seg, b))
    picks = np.tile(np.arange(b, dtype=np.int32), (m, 1))
    return picks, packs


def _scale_online_packed_tiles_chunk(d):
    import torch

    from ..models.online_lda import (
        _packed_tiles_run,
        make_online_packed_tiles_chunk,
    )
    from ..ops.packed import plan_tile_pack_uniform

    picks, packs = _spacks(d)
    plan = plan_tile_pack_uniform([pk[:3] for pk in packs], b=d["b"],
                                  k=d["k"])
    chunk = make_online_packed_tiles_chunk(
        _sgamma_rows(d["b"], d["k"]), device=_cpu(), rng_device=_cpu(),
        grid=_sgrid(), **_sonline_kw(d))
    return _packed_tiles_run, (
        _sf32(d["k"], _shard(d["v"])), _sfake(torch.int64), len(packs),
        lambda lam: chunk(lam, 0, picks, packs, plan))


def _scale_online_packed_chunk(d):
    import torch

    from ..models.online_lda import _packed_flat_run, make_online_packed_chunk

    picks, packs = _spacks(d)
    chunk = make_online_packed_chunk(
        _sgamma_rows(d["b"], d["k"]), device=_cpu(), rng_device=_cpu(),
        grid=_sgrid(), **_sonline_kw(d))
    return _packed_flat_run, (
        _sf32(d["k"], _shard(d["v"])), _sfake(torch.int64), len(packs),
        lambda lam: chunk(lam, 0, picks, packs))


def _scale_online_resident(d, m: int):
    import numpy as np
    import torch

    from ..models.online_lda import (
        make_online_chunk_runner,
        make_online_resident_chunk,
    )

    # the resident rows are one minibatch's worth: b docs of l terms
    b = d["b"]
    nonempty = np.ones(b + 1, bool)
    nonempty[b] = False
    chunk = make_online_resident_chunk(
        _si32(b, d["l"]), _sf32(b, d["l"]), nonempty,
        lambda it: np.roll(np.arange(b, dtype=np.int32), it),
        _sgamma_rows(b, d["k"]), n=b, bsz=b, rng_device=_cpu(),
        grid=_sgrid(), **_sonline_kw(d))
    return make_online_chunk_runner(chunk), (
        _sf32(d["k"], _shard(d["v"])), _sfake(torch.int64), m)


def _scale_online_resident_chunk(d):
    return _scale_online_resident(d, 2)


def _scale_online_resident_step(d):
    return _scale_online_resident(d, 1)


def _scale_nmf_chunk_runner(d):
    return _scale_nmf_padded(d, 2)


def _scale_nmf_loss(d):
    from ..models.nmf import _loss_run

    fn = functools.partial(_loss_run, grid=_sgrid())
    return fn, (_sbatch(d["b"], d["l"]), _sf32(d["b"], d["k"]),
                _sf32(d["k"], _shard(d["v"])))


def _scale_score_topic_inference_segments(d):
    from ..models.base import _segments

    args, offsets = _ssegments(d)
    fn = functools.partial(_segments, max_inner=5, offsets=offsets)
    return fn, args


# ---- kernel_io: the kernel modules' cost() bytes at the scale point ------
def _io_estep(eb, cts, alpha, gamma0):
    from ..ops.estep import cost

    return cost(eb, cts, alpha, gamma0, max_inner=5)[0]


def _io_tiles(d):
    def io(eb_kt, cts, seg, alpha, gamma0):
        from ..ops.packed import cost

        return cost(eb_kt, cts, seg, alpha, gamma0, d, max_inner=5)[0]

    return io


def _io_nmf(d):
    def io(hg_kt, cts, seg, w_slots, hht):
        from ..ops.nmf import cost

        return cost(hg_kt, cts, seg, w_slots, hht, d)[0]

    return io


def _io_segments(eb_tok, cts, seg, alpha, gamma0):
    from ..ops.segments import cost

    # every slot live: cost() reads the offsets only with lens
    return cost(eb_tok, cts, None, alpha, gamma0, max_inner=5)[0]


# ---- the specs -----------------------------------------------------------
def _dims_kv():
    return {"k": ScaleDim((SCALE_K,)), "v": ScaleDim((SCALE_V,))}


def _dims_kv_bl():
    d = _dims_kv()
    d["b"] = ScaleDim(_SCALE_B, bucketed=True)
    d["l"] = ScaleDim(_SCALE_L, bucketed=True)
    return d


def _dims_kv_bt():
    d = _dims_kv()
    d["b"] = ScaleDim(_SCALE_B, bucketed=True)
    d["t"] = ScaleDim(_SCALE_T, bucketed=True)
    return d


def _dims_tiles():
    return {
        "k": ScaleDim((SCALE_K,)),
        "tiles": ScaleDim(_SCALE_TILES, bucketed=True),
        "tt": ScaleDim((_SCALE_TT,)),
        "d": ScaleDim((_SCALE_D,)),
    }


def _dims_serve():
    return {
        "k": ScaleDim((SCALE_K,)),
        "b": ScaleDim((64,)),
        "t": ScaleDim(_SCALE_SERVE_T, bucketed=True),
    }


_CORPUS = {"corpus": ScaleDim(_SCALE_CORPUS)}
_SHARDED = dict(sharded_dims=("v",), model_shards=SCALE_MODEL_SHARDS)
_PLAIN_PEAK = (
    "the peak is the kernel wrapper's plain version's on CPU tensors, an "
    "upper bound of the card's: the kernel keeps its per-token "
    "temporaries in shared memory; kernel_io_bytes is its cost() bytes")

_SCALE_EM_BUCKET = ScaleSpec(dims=_dims_kv_bl(),
                             build=_scale_em_bucket_step, **_SHARDED)
_SCALE_EM_TRAIN = ScaleSpec(dims=_dims_kv_bl(), build=_scale_em_train_step,
                            steps=2, **_SHARDED)
_SCALE_EM_LOGLIK = ScaleSpec(dims=_dims_kv_bt(),
                             build=_scale_em_packed_loglik, **_SHARDED)
_SCALE_ONLINE_TRAIN = ScaleSpec(dims={**_dims_kv_bl(), **_CORPUS},
                                build=_scale_online_train_step, **_SHARDED)
_SCALE_ONLINE_ESTEP = ScaleSpec(dims=_dims_kv_bl(),
                                build=_scale_online_estep, **_SHARDED)
_SCALE_ONLINE_MSTEP = ScaleSpec(
    dims={**_dims_kv(), "b": ScaleDim(_SCALE_B, bucketed=True), **_CORPUS},
    build=_scale_online_mstep, **_SHARDED)
_SCALE_NMF_TRAIN = ScaleSpec(dims=_dims_kv_bl(),
                             build=_scale_nmf_train_step, **_SHARDED)
_SCALE_NMF_PACKED = ScaleSpec(dims=_dims_kv_bt(),
                              build=_scale_nmf_packed_chunk, steps=2,
                              **_SHARDED)
_SCALE_NMF_FUSED = ScaleSpec(
    dims={**_dims_tiles(), "v": ScaleDim((SCALE_V,))},
    build=_scale_nmf_fused_chunk, steps=2, **_SHARDED)
_SCALE_NMF_SOLVE_W = ScaleSpec(
    dims=_dims_kv_bl(), build=_scale_nmf_solve_w,
    note=("single-card transform tier: the port's transform takes X H^T "
          "and H H^T from its caller, so no V-wide operand reaches it; "
          "the JAX twin gathers H [k, V] itself (its STC212 waiver)"))
_SCALE_TILES_RESIDENT = ScaleSpec(
    dims={**_dims_tiles(), "v": ScaleDim((SCALE_V,)), **_CORPUS},
    build=_scale_online_tiles_resident_chunk, steps=2, **_SHARDED)
_SCALE_SHARDED_INFER = ScaleSpec(dims=_dims_kv_bl(),
                                 build=_scale_sharded_topic_inference,
                                 **_SHARDED)
_SCALE_SHARDED_LOGLIK = ScaleSpec(dims={**_dims_kv_bl(), **_CORPUS},
                                  build=_scale_sharded_log_likelihood,
                                  **_SHARDED)
_SCALE_SHARDED_EM_LOGLIK = ScaleSpec(dims=_dims_kv_bl(),
                                     build=_scale_sharded_em_log_likelihood,
                                     **_SHARDED)
_SCALE_PALLAS_ESTEP = ScaleSpec(
    dims={"k": ScaleDim((SCALE_K,)), "b": ScaleDim(_SCALE_B, bucketed=True),
          "l": ScaleDim(_SCALE_L, bucketed=True)},
    build=_scale_pallas_estep_bkl, kernel_io=_io_estep,
    note=f"csrc/estep.cu: {_PLAIN_PEAK}")
_SCALE_PALLAS_TILES = ScaleSpec(
    dims=_dims_tiles(), build=_scale_pallas_packed_tiles,
    kernel_io=_io_tiles(_SCALE_D), note=f"csrc/packed.cu: {_PLAIN_PEAK}")
_SCALE_PALLAS_NMF = ScaleSpec(
    dims=_dims_tiles(), build=_scale_pallas_nmf_mu_update,
    kernel_io=_io_nmf(_SCALE_D), note=f"csrc/nmf.cu: {_PLAIN_PEAK}")
_SCALE_LDA_ESTEP = ScaleSpec(
    dims=_dims_kv_bl(), build=_scale_lda_math_e_step,
    note=("single-card scoring tier: exp(E[log beta]) [k, V] is whole-model "
          "by design (the sharded_eval twins own the sharded width); at "
          "V=10M it is 20 GB of one card's 80 GB"))
_SCALE_SERVE_FROZEN = ScaleSpec(
    dims=_dims_serve(), build=_scale_serve_topic_inference,
    kernel_io=_io_segments, note=f"csrc/segments.cu: {_PLAIN_PEAK}")
_SCALE_SCORE_GATHER = ScaleSpec(
    dims={**_dims_kv(), "t": ScaleDim(_SCALE_T, bucketed=True)},
    build=_scale_score_gather,
    note=("single-replica serve tier gathers from a replicated [V, k] "
          "table: 20 GB at V=10M, inside one card's 80 GB"))
# the port's labels, each with the dims of the JAX sibling doing its work
# em.packed_chunk: em_lda.packed_loglik's (the packed layout)
_SCALE_EM_PACKED = ScaleSpec(dims=_dims_kv_bt(),
                             build=_scale_em_packed_chunk, steps=2,
                             **_SHARDED)
# online.eb: the [k, V] table online_lda.train_step reads, its k and v
_SCALE_ONLINE_EB = ScaleSpec(dims=_dims_kv(), build=_scale_online_eb,
                             **_SHARDED)
# online.packed_tiles_chunk / online.packed_chunk: online_lda.train_step's
# update on em_lda.packed_loglik's packed token grid
_SCALE_ONLINE_PACKED_TILES = ScaleSpec(
    dims={**_dims_kv_bt(), **_CORPUS},
    build=_scale_online_packed_tiles_chunk, steps=2, **_SHARDED)
_SCALE_ONLINE_PACKED = ScaleSpec(dims={**_dims_kv_bt(), **_CORPUS},
                                 build=_scale_online_packed_chunk, steps=2,
                                 **_SHARDED)
# online.resident_chunk / online.resident_step: online_lda.train_step's
_SCALE_ONLINE_RESIDENT_CHUNK = ScaleSpec(
    dims={**_dims_kv_bl(), **_CORPUS}, build=_scale_online_resident_chunk,
    steps=2, **_SHARDED)
_SCALE_ONLINE_RESIDENT_STEP = ScaleSpec(
    dims={**_dims_kv_bl(), **_CORPUS}, build=_scale_online_resident_step,
    **_SHARDED)
# nmf.chunk_runner / nmf.loss: nmf.train_step's
_SCALE_NMF_CHUNK = ScaleSpec(dims=_dims_kv_bl(),
                             build=_scale_nmf_chunk_runner, steps=2,
                             **_SHARDED)
_SCALE_NMF_LOSS = ScaleSpec(dims=_dims_kv_bl(), build=_scale_nmf_loss,
                            **_SHARDED)
# score.topic_inference_segments: serving.topic_inference_frozen's
_SCALE_SCORE_SEGMENTS = ScaleSpec(
    dims=_dims_serve(), build=_scale_score_topic_inference_segments,
    kernel_io=_io_segments,
    note=(f"csrc/segments.cu (per_doc convergence): {_PLAIN_PEAK}"))


ENTRYPOINTS: Tuple[EntryPoint, ...] = (
    # ---- the JAX package's twenty names, with its multichip flags ----
    EntryPoint("em_lda.bucket_step", True, _build_em_bucket_step,
               scale=_SCALE_EM_BUCKET),
    EntryPoint("em_lda.train_step", True, _build_em_train_step,
               scale=_SCALE_EM_TRAIN),
    EntryPoint("em_lda.packed_loglik", True, _build_em_packed_loglik,
               scale=_SCALE_EM_LOGLIK),
    EntryPoint("online_lda.train_step", True, _build_online_train_step,
               scale=_SCALE_ONLINE_TRAIN),
    EntryPoint("online_lda.estep", True, _build_online_estep,
               scale=_SCALE_ONLINE_ESTEP),
    EntryPoint("online_lda.mstep", True, _build_online_mstep,
               scale=_SCALE_ONLINE_MSTEP),
    EntryPoint("nmf.train_step", True, _build_nmf_train_step,
               scale=_SCALE_NMF_TRAIN),
    EntryPoint("nmf.packed_chunk", True, _build_nmf_packed_chunk,
               scale=_SCALE_NMF_PACKED),
    EntryPoint("nmf.fused_chunk", True, _build_nmf_fused_chunk,
               scale=_SCALE_NMF_FUSED),
    EntryPoint("nmf.solve_w", False, _build_nmf_solve_w,
               scale=_SCALE_NMF_SOLVE_W),
    EntryPoint("online_lda.tiles_resident_chunk", True,
               _build_online_tiles_resident_chunk,
               scale=_SCALE_TILES_RESIDENT),
    EntryPoint("sharded_eval.topic_inference", True,
               _build_sharded_topic_inference,
               scale=_SCALE_SHARDED_INFER),
    EntryPoint("sharded_eval.log_likelihood", True,
               _build_sharded_log_likelihood,
               scale=_SCALE_SHARDED_LOGLIK),
    EntryPoint("sharded_eval.em_log_likelihood", True,
               _build_sharded_em_log_likelihood,
               scale=_SCALE_SHARDED_EM_LOGLIK),
    EntryPoint("ops.pallas_estep.gamma_fixed_point_bkl", False,
               _build_pallas_estep_bkl,
               scale=_SCALE_PALLAS_ESTEP),
    EntryPoint("ops.pallas_packed.gamma_fixed_point_tiles", False,
               _build_pallas_packed_tiles,
               scale=_SCALE_PALLAS_TILES),
    EntryPoint("ops.pallas_nmf.mu_update_tiles", False,
               _build_pallas_nmf_mu_update,
               scale=_SCALE_PALLAS_NMF),
    EntryPoint("ops.lda_math.e_step", False, _build_lda_math_e_step,
               scale=_SCALE_LDA_ESTEP),
    EntryPoint("serving.topic_inference_frozen", False,
               _build_serve_topic_inference,
               scale=_SCALE_SERVE_FROZEN),
    EntryPoint("models.score_gather", False, _build_score_gather,
               scale=_SCALE_SCORE_GATHER),
    # ---- the port's labels that no JAX name covers --------------------
    EntryPoint("em.packed_chunk", True, _build_em_packed_chunk,
               scale=_SCALE_EM_PACKED),
    EntryPoint("online.eb", True, _build_online_eb,
               scale=_SCALE_ONLINE_EB),
    EntryPoint("online.packed_tiles_chunk", True,
               _build_online_packed_tiles_chunk,
               scale=_SCALE_ONLINE_PACKED_TILES),
    EntryPoint("online.packed_chunk", True, _build_online_packed_chunk,
               scale=_SCALE_ONLINE_PACKED),
    EntryPoint("online.resident_chunk", True, _build_online_resident_chunk,
               scale=_SCALE_ONLINE_RESIDENT_CHUNK),
    EntryPoint("online.resident_step", True, _build_online_resident_step,
               scale=_SCALE_ONLINE_RESIDENT_STEP),
    EntryPoint("nmf.chunk_runner", True, _build_nmf_chunk_runner,
               scale=_SCALE_NMF_CHUNK),
    EntryPoint("nmf.loss", True, _build_nmf_loss,
               scale=_SCALE_NMF_LOSS),
    EntryPoint("score.topic_inference_segments", False,
               _build_score_topic_inference_segments,
               scale=_SCALE_SCORE_SEGMENTS),
)

# entry name -> the dispatch labels whose callable it audits (the kernel
# wrappers are called inside dispatches, under none of their own)
ENTRY_LABELS: Dict[str, Tuple[str, ...]] = {
    "em_lda.bucket_step": ("em.bucket_step",),
    "em_lda.train_step": ("em.chunk_runner",),
    "em_lda.packed_loglik": ("em.packed_loglik",),
    "online_lda.train_step": ("stream.online_step",),
    "online_lda.estep": ("online.estep",),
    "online_lda.mstep": ("online.mstep",),
    "nmf.train_step": ("nmf.train_step",),
    "nmf.packed_chunk": ("nmf.packed_chunk",),
    "nmf.fused_chunk": ("nmf.fused_chunk",),
    "nmf.solve_w": ("nmf.solve_w",),
    "online_lda.tiles_resident_chunk": ("online.tiles_resident_chunk",),
    # the grid's evaluators and the one-device padded EM fit's per-bucket
    # evaluator share the JAX label
    "sharded_eval.topic_inference": ("sharded_eval.topic_inference",),
    "sharded_eval.log_likelihood": ("sharded_eval.log_likelihood",),
    "sharded_eval.em_log_likelihood": ("sharded_eval.em_log_likelihood",),
    "ops.pallas_estep.gamma_fixed_point_bkl": (),
    "ops.pallas_packed.gamma_fixed_point_tiles": (),
    "ops.pallas_nmf.mu_update_tiles": (),
    "ops.lda_math.e_step": ("score.topic_inference",),
    "serving.topic_inference_frozen": ("serve.topic_inference",),
    # one callable (gather_token_rows) under the scoring and serving labels
    "models.score_gather": ("score.gather", "serve.gather"),
    "em.packed_chunk": ("em.packed_chunk",),
    "online.eb": ("online.eb",),
    "online.packed_tiles_chunk": ("online.packed_tiles_chunk",),
    "online.packed_chunk": ("online.packed_chunk",),
    "online.resident_chunk": ("online.resident_chunk",),
    "online.resident_step": ("online.resident_step",),
    "nmf.chunk_runner": ("nmf.chunk_runner",),
    "nmf.loss": ("nmf.loss",),
    "score.topic_inference_segments": ("score.topic_inference_segments",),
}


def entrypoint_names() -> List[str]:
    return [ep.name for ep in ENTRYPOINTS]
