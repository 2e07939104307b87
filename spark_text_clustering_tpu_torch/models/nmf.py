"""Sparse non-negative matrix factorization on one device: the JAX
package's "estimator swap" (its ``models/nmf.py``).

X ~= W H over the same sparse rows the LDA estimators take (counts or
TF-IDF), by Lee-Seung multiplicative updates on the Frobenius objective:

    W <- W * (X H^T) / (W (H H^T) + eps)     X H^T: H gathered at the tokens
    H <- H * (W^T X) / ((W^T W) H + eps)     W^T X: a scatter-add over vocab

Layouts follow the JAX package's decision (``token_layout``):

  * "padded" — the [B, L] grid; "auto" takes it when padding costs less
    than 2x the token count.
  * "packed" — flat doc-contiguous tokens, work scaling with the true
    token count.  The corpus is tiled once (``ops.packed.plan_corpus_tiles``)
    and the whole W side of a sweep runs in ``ops.nmf.nmf_mu_update_tiles``
    (the CUDA kernel on the card, its plain version on the CPU); where no
    tile geometry fits the plan's budget (a doc wider than the widest tile),
    the flat layout's segment sums in plain torch.  The choice follows the
    plan alone.

The H-side scatter is ``index_add_``.  W0 and H0 are the scaled-uniform
draws of the JAX package (``E[(W H)_ij] == mean(X)``) from a
``torch.Generator`` seeded by (seed, 0x4E4D) on ``rng_device``; torch
cannot replay JAX's draws, so ``fit`` also takes them from the caller
(``init=``, see ``interop.nmf_init_from_numpy``).

On a ``parallel.ProcessGrid`` of ``data x model`` ranks, as in the JAX
package, W is cut over "data" (padded: blocks of rows, ``b_pad`` a
multiple of the data shards; flat packed: the JAX package's greedy
doc-to-shard packing with shard-local doc rows; tiles: each data rank's
block of ``plan_corpus_tiles(n_shards=D)``, W in tile-slot order) and H
over the vocabulary on "model" (zero columns pad V to V_pad).  A sweep
gathers H at the rank's tokens from the vocabulary shards, sums H Hᵀ over
"model", Wᵀ W and the scattered Wᵀ X over "data".  W0 and H0 are the
1x1 draws whatever the grid and layout, so a grid fit from a seed is the
1x1 fit up to summation order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import telemetry
from ..config import Params
from ..device import resolve_device
from ..ops.lda_math import seeded_generator
from ..ops.nmf import nmf_mu_update_tiles
from ..ops.packed import plan_corpus_tiles
from ..ops.sparse import DocTermBatch, batch_from_rows, next_pow2
from ..parallel.collectives import (
    data_shard_rows,
    gather_model_rows_kbl,
    model_handoff,
    note_host_handoff,
    psum_data,
    psum_model,
    scatter_add_model_shard,
)
from ..parallel.mesh import make_grid
from ..utils.timing import IterationTimer

__all__ = [
    "NMF",
    "NMFInit",
    "NMFModel",
    "docs_w_to_tiles",
    "frobenius_loss",
    "packed_sweeps",
    "padded_step",
]

_EPS = 1e-9      # multiplicative-update guard; keeps factors >= 0
_INIT_KEY = 0x4E4D  # the init's generator: (seed, 0x4E4D)


class NMFInit(NamedTuple):
    """Initial factors in the caller's doc order: w [n, k], h [k, V]."""

    w: np.ndarray
    h: np.ndarray


# ---- one sweep, each layout -------------------------------------------------
# On a grid (``grid`` given) W is this rank's rows and H its vocabulary
# shard; each helper is the one-device operation where ``grid`` is None.
def _sum_data(x, grid):
    return x if grid is None else psum_data(grid, x)


def _hht(h, grid):
    """H Hᵀ [k, k], summed over the vocabulary shards."""
    return h @ h.T if grid is None else psum_model(grid, h @ h.T)


def _h_at(h, flat_ids, grid):
    """H at the token ids, [k, T]."""
    if grid is None:
        return h.index_select(1, flat_ids)
    return gather_model_rows_kbl(grid, h, flat_ids)


def _h_update(h, wtx, w, eps, grid=None):
    wtw = _sum_data(w.T @ w, grid)                             # [k, k]
    return h * wtx / (wtw @ h + eps)


def _scatter_vocab(flat_ids, vals, v):
    """W^T X: token values [T, k] added into their vocab columns, [k, V]."""
    out = torch.zeros((v, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, flat_ids, vals).T


def _wtx(flat_ids, vals, h, grid):
    """W^T X over H's columns: on a grid this shard's, summed over the
    data shards."""
    if grid is None:
        return _scatter_vocab(flat_ids, vals, h.shape[1])
    return psum_data(grid, scatter_add_model_shard(grid, flat_ids, vals,
                                                   h.shape[1]))


def _slot_ids(seg_t: torch.Tensor, d: int) -> torch.Tensor:
    """Tile-layout token -> W-slot index; pad tokens point at a real slot
    and carry cts == 0."""
    tile = torch.arange(seg_t.shape[0], device=seg_t.device)[:, None]
    return (tile * d + seg_t.long().clamp(max=d - 1)).reshape(-1)


def docs_w_to_tiles(w_doc: torch.Tensor, doc_ids: np.ndarray) -> torch.Tensor:
    """Doc-ordered W [n, k] -> tile-slot order [n_tiles * d, k]; pad slots
    (doc id n) read an all-zero row, and the update keeps them at 0."""
    padded = torch.cat([w_doc, w_doc.new_zeros((1, w_doc.shape[1]))])
    idx = torch.from_numpy(doc_ids.reshape(-1).astype(np.int64))
    return padded[idx.to(w_doc.device)]


def packed_sweeps(
    w: torch.Tensor,         # tiles: [n_tiles * d, k]; flat: [d_max, k]
    h: torch.Tensor,         # [k, V]
    ids_t: torch.Tensor,     # tiles: [n_tiles, tt] int32; flat: [T] int32
    cts_t: torch.Tensor,     # float32, the shape of ids_t
    seg_t: torch.Tensor,     # int32: tile-local slots (pad == d) | doc rows
    x2: float,               # sum(X^2), a host constant of the corpus
    m: int,
    d: Optional[int] = None,
    eps: float = _EPS,
    on_sweep=None,
    grid=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``m`` Lee-Seung sweeps over the packed layout, then the Frobenius
    loss: ``(w, h, loss)``.  ``d`` given: the tile layout, whose W side is
    ``nmf_mu_update_tiles``; ``d=None``: the flat layout's segment sums.
    ``on_sweep`` is called after each sweep.  On a ``grid``: this rank's
    tokens and W rows, H its vocabulary shard; the loss is the whole
    corpus's on every rank."""
    tiles = d is not None
    flat_ids = ids_t.reshape(-1).long()
    flat_cts = cts_t.reshape(-1)
    seg_l = seg_t.long()
    for _ in range(m):
        hht = _hht(h, grid)                                    # [k, k]
        if tiles:
            hg_kt = _h_at(h, flat_ids, grid)                   # [k, T]
            w, vals = nmf_mu_update_tiles(hg_kt, cts_t, seg_t, w, hht, d, eps)
        else:
            hg = _h_at(h, flat_ids, grid).T                    # [T, k]
            xht = torch.zeros_like(w).index_add_(
                0, seg_l, flat_cts[:, None] * hg)
            w = w * xht / (w @ hht + eps)
            vals = flat_cts[:, None] * w[seg_l]                # [T, k]
        h = _h_update(h, _wtx(flat_ids, vals, h, grid), w, eps, grid)
        if on_sweep is not None:
            on_sweep()
    # ||X - W H||^2 = ||X||^2 - 2 sum_nz x (W H) + tr((W^T W)(H H^T))
    w_tok = w[_slot_ids(seg_t, d)] if tiles else w[seg_l]     # [T, k]
    hg = _h_at(h, flat_ids, grid).T
    cross = _sum_data(((hg * w_tok).sum(-1) * flat_cts).sum().reshape(1),
                      grid)[0]
    loss = (torch.tensor(x2, dtype=torch.float32, device=h.device)
            - 2.0 * cross + (_sum_data(w.T @ w, grid) * _hht(h, grid)).sum())
    return w, h, loss


def padded_step(w, h, ids, wts, eps: float = _EPS, grid=None):
    """One sweep over the padded [B, L] grid: ``(w, h)``.  Pad docs and pad
    slots carry weight 0 and stay inert.  On a ``grid``: this rank's rows
    and W rows, H its vocabulary shard."""
    flat = ids.reshape(-1).long()
    hg = _h_at(h, flat, grid).T.reshape(*ids.shape, -1)        # [B, L, k]
    xht = torch.einsum("blk,bl->bk", hg, wts)
    w = w * xht / (w @ _hht(h, grid) + eps)
    vals = wts[..., None] * w[:, None, :]                      # [B, L, k]
    h = _h_update(h, _wtx(flat, vals.reshape(-1, vals.shape[-1]), h, grid),
                  w, eps, grid)
    return w, h


def frobenius_loss(batch: DocTermBatch, w, h, grid=None) -> torch.Tensor:
    """||X - W H||_F^2 over a padded batch, without densifying X; on a
    ``grid`` over every rank's rows."""
    ids, wts = batch.token_ids, batch.token_weights
    hg = _h_at(h, ids.reshape(-1).long(), grid).T.reshape(*ids.shape, -1)
    cross = (wts * torch.einsum("blk,bk->bl", hg, w)).sum()
    sums = _sum_data(torch.stack([(wts ** 2).sum(), cross]), grid)
    return sums[0] - 2.0 * sums[1] + (
        _sum_data(w.T @ w, grid) * _hht(h, grid)).sum()


_loss_run = telemetry.instrument_dispatch("nmf.loss", frobenius_loss)


def _solve_w(xht: torch.Tensor, hht: torch.Tensor, n_iter) -> torch.Tensor:
    """W [n, k] from 1/k after ``n_iter`` multiplicative updates against
    the fixed numerator X H^T and H H^T."""
    n, k = xht.shape
    w = torch.full((n, k), 1.0 / k, dtype=torch.float32, device=xht.device)
    for _ in range(int(n_iter)):
        w = w * xht / (w @ hht + _EPS)
    return w


# the depth rides as a tensor, so transforms of one batch shape share a
# signature whatever their depth (the JAX package's dynamic n_iter)
_solve_w_run = telemetry.instrument_dispatch("nmf.solve_w", _solve_w)


# ---- the model ---------------------------------------------------------------
@dataclass
class NMFModel:
    """Fitted factorization: ``h`` [k, V] topic-term factors + vocabulary.
    The topic-facing surface mirrors ``LDAModel`` (``describe_topics``,
    ``topic_distribution``), so scoring code need not know the estimator.
    ``transform`` and ``topic_distribution`` run on ``device``."""

    h: np.ndarray                      # [k, V] float32
    vocab: List[str]
    loss: float = float("nan")         # final Frobenius objective
    iteration_times: List[float] = field(default_factory=list)
    iteration_times_kind: str = "per_iteration"
    step: int = 0
    device: str = "cuda"

    @property
    def k(self) -> int:
        return int(self.h.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.h.shape[1])

    def topics_matrix(self) -> np.ndarray:
        """Row-normalized topic-term distributions [k, V] (float64)."""
        h = np.asarray(self.h, np.float64)
        return h / np.maximum(h.sum(axis=1, keepdims=True), _EPS)

    def describe_topics(
        self, max_terms_per_topic: int = 10
    ) -> List[List[Tuple[int, float]]]:
        out = []
        for row in self.topics_matrix():
            top = np.argsort(-row, kind="stable")[:max_terms_per_topic]
            out.append([(int(i), float(row[i])) for i in top])
        return out

    def describe_topics_terms(
        self, max_terms_per_topic: int = 10
    ) -> List[List[Tuple[str, float]]]:
        return [
            [(self.vocab[i], w) for i, w in topic]
            for topic in self.describe_topics(max_terms_per_topic)
        ]

    def transform(
        self,
        docs: Union[DocTermBatch, Sequence[Tuple[np.ndarray, np.ndarray]]],
        n_iter: int = 100,
        mesh=None,
        device=None,
        grid=None,
    ) -> np.ndarray:
        """Doc factors W [n, k] for ``docs`` with H fixed: ``n_iter`` W
        updates from 1/k.  ``mesh`` and ``grid`` are accepted for the
        estimator-agnostic scoring surface: as in the JAX package the
        solve runs unsharded, on the rank's device on a grid."""
        if device is None:
            device = self.device if grid is None else grid.device
        dev = resolve_device(device)
        if isinstance(docs, DocTermBatch):
            n, width = docs.token_ids.shape
            ids = docs.token_ids.reshape(-1).to(dev).long()
            cts = docs.token_weights.reshape(-1).to(dev)
            seg = torch.arange(n, device=dev).repeat_interleave(width)
        else:
            rows = list(docs)
            n = len(rows)
            lens = [len(i) for i, _ in rows]
            ids = torch.from_numpy(np.concatenate(
                [np.asarray(i, np.int64) for i, _ in rows] or
                [np.zeros(0, np.int64)])).to(dev)
            cts = torch.from_numpy(np.concatenate(
                [np.asarray(w, np.float32) for _, w in rows] or
                [np.zeros(0, np.float32)])).to(dev)
            seg = torch.repeat_interleave(
                torch.arange(n), torch.as_tensor(lens, dtype=torch.long)
            ).to(dev)
        h = torch.as_tensor(np.asarray(self.h, np.float32), device=dev)
        # the numerator X H^T is fixed: one segment sum over the tokens
        xht = torch.zeros((n, self.k), dtype=torch.float32,
                          device=dev).index_add_(
            0, seg, cts[:, None] * h.index_select(1, ids).T)
        return _solve_w_run(xht, h @ h.T, torch.tensor(int(n_iter))).cpu(
        ).numpy()

    def topic_distribution(
        self, docs, n_iter: int = 100, mesh=None, convergence: str = "batch",
        device=None, grid=None,
    ) -> np.ndarray:
        """Row-normalized W, the ``LDAModel.topic_distribution`` analogue;
        empty docs get the uniform row.  ``convergence`` is accepted for
        that surface: the fixed-depth solve has no early exit, so each
        row depends on its own doc only under either setting."""
        if convergence not in ("batch", "per_doc"):
            raise ValueError(
                f"convergence must be 'batch' or 'per_doc', got {convergence!r}"
            )
        w = self.transform(docs, n_iter=n_iter, mesh=mesh, device=device,
                           grid=grid)
        totals = w.sum(axis=1, keepdims=True)
        uniform = np.full_like(w, 1.0 / self.k)
        return np.where(totals > 0, w / np.maximum(totals, _EPS), uniform)

    def save(self, path: str) -> None:
        from .persistence import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "NMFModel":
        from .persistence import load_model

        model = load_model(path, device=device)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}")
        return model




# ---- the estimator -------------------------------------------------------------
class NMF:
    """Estimator: ``fit(rows, vocab) -> NMFModel``, reading ``k``,
    ``max_iterations``, ``seed`` and ``token_layout`` from ``Params``.

    ``grid`` (a ``parallel.ProcessGrid``) fits on a grid of ranks, each
    rank calling ``fit`` with the same rows; without one, a ``params``
    that asks for shards takes the grid of the started world
    (``parallel.make_grid``).  Every rank returns the same model.

    After a fit: ``last_layout`` ("padded" | "packed"),
    ``last_mu_backend`` ("cuda_tiles" | "plain_tiles" | "flat" | "none"
    for padded), ``last_loss``, ``last_cells`` (token cells a sweep
    covers) and ``last_tiles`` (the tile geometry, or None)."""

    def __init__(self, params: Params, device="cuda", rng_device=None,
                 grid=None) -> None:
        if grid is None and (params.model_shards != 1
                             or params.data_shards not in (None, 1)):
            grid = make_grid(params.data_shards, params.model_shards,
                             device=device)
        if grid is not None:
            params = params.replace(data_shards=grid.data_shards,
                                    model_shards=grid.model_shards)
            device = grid.device
        self.params = params
        self.grid = grid if grid is not None and grid.size > 1 else None
        self.device = resolve_device(device)
        self.rng_device = (
            self.device if rng_device is None else resolve_device(rng_device)
        )
        self.last_loss: Optional[float] = None
        self.last_layout = "padded"
        self.last_mu_backend = "none"
        self.last_cells: Optional[int] = None
        self.last_tiles: Optional[dict] = None

    @property
    def _data(self) -> Tuple[int, int]:
        """(this rank's data shard, the data shards)."""
        g = self.grid
        return (0, 1) if g is None else (g.d, g.data_shards)

    def _init(self, n: int, k: int, v: int, weight_sum: float):
        """Scaled-uniform W0 [n, k], H0 [k, v]: E[(W H)_ij] == mean(X) at
        iteration 0, from unpadded n and v."""
        mean_x = weight_sum / max(n * v, 1)
        scale = float(np.sqrt(max(mean_x, _EPS) / k))
        gen = seeded_generator(self.rng_device, self.params.seed, _INIT_KEY)
        opts = dict(generator=gen, dtype=torch.float32, device=self.rng_device)
        w = scale * (0.5 + torch.rand((n, k), **opts))
        h = scale * (0.5 + torch.rand((k, v), **opts))
        return w.to(self.device), h.to(self.device)

    def _packed_plan(self, rows, n: int):
        """Doc-contiguous token packing, docs longest first (stable), each
        to the data shard with the fewest tokens so far (the JAX package's
        greedy packing).  Returns (ids_t, cts_t, seg_t flat [n_data *
        t_max], shard after shard, with seg the doc's row on its shard,
        slot [n] doc -> packed W row ``shard * d_max + row``, d_max docs a
        shard, cells)."""
        n_data = self._data[1]
        order = sorted(range(n), key=lambda doc: -len(rows[doc][0]))
        shard_docs: List[List[int]] = [[] for _ in range(n_data)]
        loads = [0] * n_data
        for doc in order:
            s = loads.index(min(loads))
            shard_docs[s].append(doc)
            loads[s] += max(1, len(rows[doc][0]))
        d_max = max(1, max(len(sd) for sd in shard_docs))
        # token axis: pow2 while small, 8192-multiples beyond
        t_need = max(8, max(loads))
        t_max = (
            next_pow2(t_need) if t_need <= 8192
            else ((t_need + 8191) // 8192) * 8192
        )
        ids_t = np.zeros((n_data, t_max), np.int32)
        cts_t = np.zeros((n_data, t_max), np.float32)
        seg_t = np.zeros((n_data, t_max), np.int32)
        slot = np.zeros(n, np.int64)
        for s, sdocs in enumerate(shard_docs):
            o = 0
            for j, doc in enumerate(sdocs):
                i, w = rows[doc]
                ids_t[s, o:o + len(i)] = i
                cts_t[s, o:o + len(i)] = w
                seg_t[s, o:o + len(i)] = j
                o += len(i)
                slot[doc] = s * d_max + j
        return (ids_t.reshape(-1), cts_t.reshape(-1), seg_t.reshape(-1), slot,
                d_max, n_data * t_max)

    def _run(self, sweep, args, m: int, verbose: bool, label: str,
             dispatch_label: str):
        """Run ``sweep(*args, m, on_sweep)``: ``m`` sweeps (and, packed,
        the loss) from the state and corpus tensors ``args``, one dispatch
        under ``dispatch_label``.  Times the whole run as one span split
        evenly over the sweeps, or, with ``verbose`` /
        ``record_iteration_times``, each sweep (a sync after each).
        Returns (result, timer)."""
        dev = self.device
        timer = IterationTimer()

        # a handle on the device for the wait (the sweeps hand no tensor
        # back between sweeps)
        on_dev = torch.empty(0, device=dev)

        def sync():
            telemetry.device_sync(on_dev, "nmf")

        per_sweep = verbose or self.params.record_iteration_times
        say = verbose and (self.grid is None or self.grid.rank == 0)

        def on_sweep():
            if per_sweep:
                sync()
                timer.stop()
                if say:
                    print(f"nmf iter {len(timer.times) - 1}: "
                          f"{timer.times[-1]:.3f}s{label}")
                if len(timer.times) < m:
                    timer.start()

        timer.start()
        out = telemetry.instrument_dispatch(dispatch_label, sweep)(
            *args, m, on_sweep)
        sync()
        if not per_sweep:
            timer.stop()
            timer.split_last(m)
        return out, timer

    def fit(
        self,
        rows: Sequence[Tuple[np.ndarray, np.ndarray]],
        vocab: List[str],
        verbose: bool = False,
        init: Optional[NMFInit] = None,
    ) -> NMFModel:
        p = self.params
        dev, g = self.device, self.grid
        k, v, n = p.k, len(vocab), len(rows)
        _, n_data = self._data
        if p.token_layout not in ("padded", "packed", "auto"):
            raise ValueError(
                f"unknown token_layout {p.token_layout!r} "
                "(use 'padded'|'packed'|'auto')"
            )
        if init is not None and (init.w.shape != (n, k)
                                 or init.h.shape != (k, v)):
            raise ValueError(
                f"init w{init.w.shape} h{init.h.shape} does not match "
                f"n={n}, k={k}, V={v}")
        shards = 1 if g is None else g.model_shards
        v_pad = -(-v // shards) * shards
        shard_v = v_pad // shards
        cols = slice(0, v) if g is None else slice(g.m * shard_v,
                                                   (g.m + 1) * shard_v)
        max_nnz = max((len(i) for i, _ in rows), default=1)
        total_nnz = sum(len(i) for i, _ in rows)
        b_pad = -(-n // n_data) * n_data
        padded_cells = b_pad * max(8, next_pow2(max_nnz))
        self.last_layout, self.last_mu_backend = "padded", "none"
        self.last_cells, self.last_tiles = padded_cells, None
        # the JAX package's threshold: packed once padding costs >= 2x
        use_packed = p.token_layout == "packed" or (
            p.token_layout == "auto" and padded_cells >= 2.0 * max(1, total_nnz)
        )
        flat_cts = (np.concatenate([np.asarray(c, np.float32) for _, c in rows])
                    if rows else np.zeros(0, np.float32))

        def start():
            """The doc-ordered W0 [n, k] and this rank's columns of H0
            (zero past V)."""
            if init is not None:
                w0 = torch.from_numpy(np.asarray(init.w, np.float32)).to(dev)
                h0 = torch.from_numpy(np.asarray(init.h, np.float32)).to(dev)
            else:
                w0, h0 = self._init(n, k, v, float(flat_cts.sum()))
            h0 = torch.nn.functional.pad(h0, (0, v_pad - v))
            return w0, h0[:, cols].contiguous()

        if use_packed and n:
            self.last_layout = "packed"
            w, h, loss, timer = self._fit_packed(rows, start, flat_cts,
                                                 verbose)
        else:
            w_doc, h = start()
            if g is None:
                batch = batch_from_rows(list(rows), device=dev)
                w = w_doc
            else:
                batch, lo, hi = data_shard_rows(
                    g, list(rows), max(8, next_pow2(max_nnz)), dev)
                # this rank's rows of W; pad docs' rows stay 0
                w = w_doc.new_zeros(batch.token_ids.shape[0], k)
                w[:hi - lo] = w_doc[lo:hi]

            def sweep(w_, h_, ids, wts, m, on_sweep):
                for _ in range(m):
                    w_, h_ = padded_step(w_, h_, ids, wts, grid=g)
                    on_sweep()
                return w_, h_

            # the JAX package's labels: the sweeps, then the loss
            (w, h), timer = self._run(
                sweep, (w, h, batch.token_ids, batch.token_weights),
                p.max_iterations, verbose, "",
                "nmf.chunk_runner" if p.max_iterations > 1
                else "nmf.train_step")
            loss = _loss_run(batch, w, h, grid=g)
        self.last_loss = float(loss)
        telemetry.emit_fit(
            "nmf", timer.times, kind=timer.kind, loss=self.last_loss,
            layout=self.last_layout, mu_backend=self.last_mu_backend,
            cells=self.last_cells,
            # the timed chunks: one, or one a sweep
            dispatches=(1 if timer.kind == "interval_mean"
                        else len(timer.times)),
            k=k, vocab_width=v, docs=n,
        )
        if g is None:
            note_host_handoff(k * v * h.element_size())
        return NMFModel(
            h=h.cpu().numpy() if g is None else model_handoff(g, h, v),
            vocab=list(vocab),
            loss=self.last_loss,
            iteration_times=list(timer.times),
            iteration_times_kind=timer.kind,
            step=p.max_iterations,
            device=str(dev),
        )

    def _fit_packed(self, rows, start, flat_cts, verbose):
        """The packed fit: tiles through the W-update kernel when a tile
        geometry fits the plan's budget, else the flat segment layout; on
        a grid each data rank takes its block of tiles or its shard of the
        greedy packing.  ``start()`` gives the doc-ordered W0 and H0."""
        p, dev, g = self.params, self.device, self.grid
        n, k = len(rows), p.k
        d_idx, n_data = self._data
        flat_ids = np.concatenate([np.asarray(i, np.int32) for i, _ in rows])
        x2 = float((flat_cts.astype(np.float64) ** 2).sum())
        w_doc, h = start()
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
        plan = plan_corpus_tiles(flat_ids, flat_cts, offsets, n_shards=n_data,
                                 k=k)
        if plan is not None:
            self.last_mu_backend = (
                "cuda_tiles" if dev.type == "cuda" else "plain_tiles")
            n_tiles = plan.ids.shape[0]
            self.last_cells = n_tiles * plan.tt
            self.last_tiles = {
                "n_tiles": int(n_tiles), "tt": plan.tt, "d": plan.d,
                "live_tokens": int((plan.seg < plan.d).sum()),
                "live_slots": int((plan.doc_ids < n).sum()),
            }
            per = n_tiles // n_data
            blk = slice(d_idx * per, (d_idx + 1) * per)
            w = docs_w_to_tiles(w_doc, plan.doc_ids[blk])
            ids, cts, seg = (torch.from_numpy(np.ascontiguousarray(a[blk])).to(
                dev) for a in (plan.ids, plan.cts, plan.seg))
            d, label, dispatch = plan.d, " (tiles)", "nmf.fused_chunk"
        else:
            self.last_mu_backend = "flat"
            ids_f, cts_f, seg_f, slot, d_max, cells = self._packed_plan(
                rows, n)
            self.last_cells = cells
            w = torch.zeros((n_data * d_max, k), dtype=torch.float32,
                            device=dev)
            w[torch.from_numpy(slot).to(dev)] = w_doc
            w = w[d_idx * d_max:(d_idx + 1) * d_max].contiguous()
            t_max = cells // n_data
            ids, cts, seg = (
                torch.from_numpy(a[d_idx * t_max:(d_idx + 1) * t_max]).to(dev)
                for a in (ids_f, cts_f, seg_f))
            d, label, dispatch = None, " (packed)", "nmf.packed_chunk"

        def sweep(w, h, ids, cts, seg, m, on_sweep):
            return packed_sweeps(w, h, ids, cts, seg, x2, m, d=d,
                                 on_sweep=on_sweep, grid=g)

        (w, h, loss), timer = self._run(sweep, (w, h, ids, cts, seg),
                                        p.max_iterations, verbose, label,
                                        dispatch)
        return w, h, loss, timer
