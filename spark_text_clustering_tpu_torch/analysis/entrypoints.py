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
fixed ``torch.Generator``.  ``scale`` is ``None`` on every entry until
the scale audit (layer 3) fills it; the type is the JAX package's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "ENTRY_LABELS",
    "ENTRYPOINTS",
    "EntryPoint",
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


@dataclass(frozen=True)
class ScaleDim:
    """One declared scale dimension: the grid of values the entry is
    dispatched at in production, and whether that grid is a bounded
    pow2 bucket set (``bucketed=True``) or a single static point."""

    points: Tuple[int, ...]
    bucketed: bool = False


@dataclass(frozen=True)
class ScaleSpec:
    """Declared scale geometry for one entry point (the layer-3 audit,
    not ported yet): ``build(dims)`` mirrors the toy builder at the
    dim-value mapping."""

    dims: Mapping[str, ScaleDim]
    build: Callable[[Dict[str, int]], Tuple[Callable, Sequence]]
    sharded_dims: Tuple[str, ...] = ()
    model_shards: int = 16
    collective_budget_bytes: Optional[int] = None
    note: str = ""


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


ENTRYPOINTS: Tuple[EntryPoint, ...] = (
    # ---- the JAX package's twenty names, with its multichip flags ----
    EntryPoint("em_lda.bucket_step", True, _build_em_bucket_step),
    EntryPoint("em_lda.train_step", True, _build_em_train_step),
    EntryPoint("em_lda.packed_loglik", True, _build_em_packed_loglik),
    EntryPoint("online_lda.train_step", True, _build_online_train_step),
    EntryPoint("online_lda.estep", True, _build_online_estep),
    EntryPoint("online_lda.mstep", True, _build_online_mstep),
    EntryPoint("nmf.train_step", True, _build_nmf_train_step),
    EntryPoint("nmf.packed_chunk", True, _build_nmf_packed_chunk),
    EntryPoint("nmf.fused_chunk", True, _build_nmf_fused_chunk),
    EntryPoint("nmf.solve_w", False, _build_nmf_solve_w),
    EntryPoint("online_lda.tiles_resident_chunk", True,
               _build_online_tiles_resident_chunk),
    EntryPoint("sharded_eval.topic_inference", True,
               _build_sharded_topic_inference),
    EntryPoint("sharded_eval.log_likelihood", True,
               _build_sharded_log_likelihood),
    EntryPoint("sharded_eval.em_log_likelihood", True,
               _build_sharded_em_log_likelihood),
    EntryPoint("ops.pallas_estep.gamma_fixed_point_bkl", False,
               _build_pallas_estep_bkl),
    EntryPoint("ops.pallas_packed.gamma_fixed_point_tiles", False,
               _build_pallas_packed_tiles),
    EntryPoint("ops.pallas_nmf.mu_update_tiles", False,
               _build_pallas_nmf_mu_update),
    EntryPoint("ops.lda_math.e_step", False, _build_lda_math_e_step),
    EntryPoint("serving.topic_inference_frozen", False,
               _build_serve_topic_inference),
    EntryPoint("models.score_gather", False, _build_score_gather),
    # ---- the port's labels that no JAX name covers --------------------
    EntryPoint("em.packed_chunk", True, _build_em_packed_chunk),
    EntryPoint("online.eb", True, _build_online_eb),
    EntryPoint("online.packed_tiles_chunk", True,
               _build_online_packed_tiles_chunk),
    EntryPoint("online.packed_chunk", True, _build_online_packed_chunk),
    EntryPoint("online.resident_chunk", True, _build_online_resident_chunk),
    EntryPoint("online.resident_step", True, _build_online_resident_step),
    EntryPoint("nmf.chunk_runner", True, _build_nmf_chunk_runner),
    EntryPoint("nmf.loss", True, _build_nmf_loss),
    EntryPoint("score.topic_inference_segments", False,
               _build_score_topic_inference_segments),
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
