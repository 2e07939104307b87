"""EM LDA on one device: MLlib's ``EMLDAOptimizer`` over the packed,
vocab-sorted token layout.

One EM sweep, per token (an edge of the doc-term graph):

    phi   ∝ (N_wk[id] + eta - 1) * (N_dk[doc] + alpha - 1) / (N_k + V*eta - V)
    N_dk' = sum over the doc's tokens of w * phi
    N_wk' = sum over the term's tokens of w * phi

The layout is the one the JAX package's fit takes (``em_layout``).  On
the packed layout the corpus is packed flat (docs longest first, each
doc's tokens contiguous) and then reordered once into the scatter plan's
vocab-sorted blocks (``ops.emscatter.plan_em_scatter``).  A sweep is the
fused kernel (``ops.emsweep.em_sweep_fused``) when the doc axis is at
most 512 slots, reading both layouts (the doc-contiguous one is uploaded
once per fit), else two stages: phi by plain gathers, then the
vocab-tiled scatter kernel (``ops.emscatter.scatter_add_vtiles``).  On
the padded layout the docs sit in [B, L] length buckets
(``em_padded_shape``) and a sweep is the JAX package's plain edge pass
(``_em_edge_pass``) per bucket, gathers and ``index_add_``: that path
has no kernel in either package.  Both layouts start from the same
per-token draw.  Counts are float32 (TF-IDF pseudo-counts).  A fit
resumes from ``<checkpoint_dir>/em_state.npz`` (n_wk [k, V_pad], n_dk
[n, k] in corpus order, step) when one is present: the JAX package's
checkpoint format, whichever layout and grid wrote it.

On a ``parallel.ProcessGrid`` of ``data x model`` ranks, as in the JAX
package, whole documents and their N_dk rows are sharded over "data"
(greedy nnz balance, ``packed_shard_plan``) and N_wk over the vocabulary
on "model", zero-padded to V_pad, a multiple of the model shards.  Each
rank runs the sweep's kernel on its own (data, model) pair of the scatter
plan, and ``all_reduce`` is the only collective.  A grid fit starts from
the 1x1 fit's counts from the same seed.
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Params
from ..device import resolve_device
from ..ops.emscatter import plan_em_scatter, scatter_add_vtiles
from ..ops.emsweep import em_sweep_fused, fused_d_pad, fused_eligible
from ..ops.emsweep import doc_stream
from ..ops.sparse import batch_from_rows, bucket_indices_by_length, next_pow2
from ..parallel.collectives import (
    data_shard_rows,
    fetch_global,
    gather_model_rows,
    model_handoff,
    model_row_sum,
    psum_data,
    psum_model,
    scatter_add_model_shard,
)
from ..parallel.mesh import agree_checkpoint_exists, is_coordinator, make_grid
from ..utils.timing import IterationTimer
from .base import LDAModel
from .persistence import load_train_state, save_train_state
from .sharded_eval import (
    make_sharded_em_log_likelihood,
    masked_row_sum,
    shard_col_mask,
)

__all__ = ["EMLDA", "em_layout", "em_padded_cells", "em_padded_shape",
           "packed_plan", "packed_log_likelihood", "packed_shard_plan"]

# Below this many single-bucket cells one padded sweep beats several
# bucketed ones (the JAX package's auto bucketing rule)
_BUCKET_MIN_CELLS = 16_000_000


def em_padded_shape(rows: Sequence[Tuple[np.ndarray, np.ndarray]],
                    bucket_by_length="auto") -> List[Tuple[int, List[int]]]:
    """The JAX package's padded layout on one data shard (its
    ``_plan_shape``): ``[(row_len, doc indices)]``, power-of-two length
    buckets sorted by length, or one bucket of ``max(8, next_pow2(max
    nnz))`` when ``bucket_by_length`` is false; ``"auto"`` (the default)
    buckets only where bucketing removes most of the padding of one
    padded batch of at least 16M cells."""
    buckets = dict(sorted(bucket_indices_by_length(rows).items()))
    use_buckets = bool(bucket_by_length)
    if use_buckets and bucket_by_length == "auto" and len(buckets) > 1:
        cells = sum(len(idxs) * width for width, idxs in buckets.items())
        single = len(rows) * max(buckets)
        if single < _BUCKET_MIN_CELLS or cells > 0.5 * single:
            use_buckets = False
    if not use_buckets:
        max_nnz = max((len(i) for i, _ in rows), default=1)
        return [(max(8, next_pow2(max_nnz)), list(range(len(rows))))]
    return list(buckets.items())


def em_padded_cells(rows: Sequence[Tuple[np.ndarray, np.ndarray]],
                    bucket_by_length="auto") -> int:
    """Token cells of one sweep on the padded layout (``em_padded_shape``)."""
    return sum(len(idxs) * width
               for width, idxs in em_padded_shape(rows, bucket_by_length))


def em_layout(rows: Sequence[Tuple[np.ndarray, np.ndarray]],
              token_layout: str, bucket_by_length="auto") -> str:
    """The layout the JAX package's EM fit runs for ``token_layout``:
    ``"packed"`` or ``"padded"``.  ``"auto"`` packs once the padded
    layout (``em_padded_cells``) costs at least twice the corpus's
    tokens."""
    if token_layout not in ("padded", "packed", "auto"):
        raise ValueError(
            f"unknown token_layout {token_layout!r} "
            "(use 'padded'|'packed'|'auto')"
        )
    if token_layout != "auto":
        return token_layout
    total_nnz = sum(len(i) for i, _ in rows)
    cells = em_padded_cells(rows, bucket_by_length)
    return "packed" if cells >= 2.0 * max(1, total_nnz) else "padded"


def packed_plan(rows: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """Doc-contiguous token packing, docs longest first (stable).

    Returns (ids [T], cts [T], seg [T] packed doc row, slot [n] corpus doc
    -> packed row, d_max) with T the total nnz."""
    n = len(rows)
    order = sorted(range(n), key=lambda d: -len(rows[d][0]))
    t_max = max(1, sum(len(rows[d][0]) for d in order))
    ids = np.zeros(t_max, np.int32)
    cts = np.zeros(t_max, np.float32)
    seg = np.zeros(t_max, np.int32)
    slot = np.zeros(n, np.int64)
    o = 0
    for j, d in enumerate(order):
        i, w = rows[d]
        ids[o:o + len(i)] = i
        cts[o:o + len(i)] = w
        seg[o:o + len(i)] = j
        o += len(i)
        slot[d] = j
    return ids, cts, seg, slot, max(1, n)


def packed_shard_plan(rows: Sequence[Tuple[np.ndarray, np.ndarray]],
                      n_data: int):
    """The JAX package's packing over ``n_data`` data shards: docs longest
    first (stable), each to the shard with the least nnz so far (the
    first such shard on a tie), its tokens contiguous there.

    Returns (ids, cts, seg [n_data, t_max] with seg the doc's row on its
    shard, slot [n] corpus doc -> ``shard * d_max + row``, d_max docs a
    shard)."""
    n = len(rows)
    order = sorted(range(n), key=lambda d: -len(rows[d][0]))
    shard_docs: List[List[int]] = [[] for _ in range(n_data)]
    loads = [0] * n_data
    for d in order:
        s = loads.index(min(loads))
        shard_docs[s].append(d)
        loads[s] += max(1, len(rows[d][0]))
    d_max = max(1, max(len(sd) for sd in shard_docs))
    t_max = max(8, next_pow2(max(loads)))
    ids = np.zeros((n_data, t_max), np.int32)
    cts = np.zeros((n_data, t_max), np.float32)
    seg = np.zeros((n_data, t_max), np.int32)
    slot = np.zeros(n, np.int64)
    for s, sdocs in enumerate(shard_docs):
        o = 0
        for j, d in enumerate(sdocs):
            i, w = rows[d]
            ids[s, o:o + len(i)] = i
            cts[s, o:o + len(i)] = w
            seg[s, o:o + len(i)] = j
            o += len(i)
            slot[d] = s * d_max + j
    return ids, cts, seg, slot, d_max


def packed_log_likelihood(n_wk, n_dk, ids, cts, seg, *, alpha, eta, v):
    """``DistributedLDAModel.logLikelihood`` over packed tokens: the sum of
    w * log(sum_k phi_wk theta_dk) with EM's smoothed estimates."""
    n_k = n_wk.sum(dim=1)
    phi_w = (n_wk[:, ids.long()].T + (eta - 1.0)) / (n_k + (eta * v - v))
    theta = (n_dk + (alpha - 1.0)) / (
        n_dk.sum(dim=-1, keepdim=True) + n_dk.shape[-1] * (alpha - 1.0)
    )
    tok = (phi_w * theta[seg.long()]).sum(dim=-1)
    safe = torch.where(tok > 0, tok, torch.ones_like(tok))
    return (cts * torch.log(safe)).sum()


class _Layout(NamedTuple):
    """A fit's state on its layout and grid.  ``sweep`` and ``loglik``
    take (n_wk, n_dk) as the layout holds them; ``put`` places host
    counts (n_wk [k, V_pad], n_dk [n, k] in corpus order) there, and
    ``get_nwk`` / ``get_ndk`` / ``lam`` bring them back to the host
    (collectives on a grid, so every rank calls them)."""

    sweep: Callable
    loglik: Callable
    put: Callable
    get_nwk: Callable
    get_ndk: Callable
    lam: Callable


class EMLDA:
    """Estimator for the EM path: ``fit(rows, vocab) -> LDAModel`` with
    the EM auto priors alpha = 50/k + 1, eta = 1.1.

    ``grid`` (a ``parallel.ProcessGrid``) fits on a grid of ranks, each
    rank calling ``fit`` with the same rows; without one, a ``params``
    that asks for shards takes the grid of the started world
    (``parallel.make_grid``).  Every rank returns the same model."""

    def __init__(self, params: Params, device="cuda", grid=None) -> None:
        if params.algorithm != "em":
            params = params.replace(algorithm="em")
        for name, val in (
            ("doc_concentration", params.doc_concentration),
            ("topic_concentration", params.topic_concentration),
        ):
            if val != -1 and val <= 1.0:
                raise ValueError(
                    f"EM requires {name} > 1 (or -1 for auto); got {val}"
                )
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
        self.last_log_likelihood: Optional[float] = None
        self.last_doc_topic_counts: Optional[np.ndarray] = None
        # "packed" or "padded": the layout the last fit ran on
        self.last_layout: str = "none"
        # "fused", "two_stage" or "padded": which sweep the last fit ran
        self.last_sweep: str = "none"

    @staticmethod
    def _init_counts(ids, cts, seg, d_max, v, k, seed):
        """Random soft assignment: per live token of the packed layout a
        Dirichlet(1) topic draw (normalized Exponential(1)) from a CPU
        generator seeded with ``seed``, aggregated on the CPU into (n_wk
        [k, V], n_dk [d_max, k] in packed row order)."""
        gen = torch.Generator().manual_seed(seed)
        e = torch.empty((ids.shape[0], k), dtype=torch.float32)
        e.exponential_(generator=gen)
        wphi = torch.from_numpy(cts)[:, None] * (e / e.sum(-1, keepdim=True))
        n_wk = torch.zeros((k, v), dtype=torch.float32).index_add_(
            1, torch.from_numpy(ids).long(), wphi.T
        )
        n_dk = torch.zeros((d_max, k), dtype=torch.float32).index_add_(
            0, torch.from_numpy(seg).long(), wphi
        )
        return n_wk, n_dk

    def _local(self, slot, d_max, k):
        """(put, get_nwk, get_ndk, lam) of a one-device layout whose n_dk
        rows sit at ``slot[d]``."""
        dev = self.device

        def put(n_wk, n_dk):
            layout_ndk = np.zeros((d_max, k), np.float32)
            layout_ndk[slot] = n_dk
            return (torch.as_tensor(n_wk, dtype=torch.float32).to(dev),
                    torch.from_numpy(layout_ndk).to(dev))

        def get_nwk(n_wk):
            return n_wk.cpu().numpy()

        return put, get_nwk, lambda n_dk: n_dk.cpu().numpy()[slot], get_nwk

    def _packed_sweep(self, ids, cts, seg, slot, d_max, v, k, alpha, eta):
        """The packed layout on one device, reordered once into the
        scatter plan's vocab-sorted blocks: the fused kernel for a doc
        axis of at most 512 slots, else the two-stage sweep."""
        dev = self.device
        plan = plan_em_scatter(ids[None], cts[None], 1, v)
        fused = fused_eligible(d_max)
        self.last_sweep = "fused" if fused else "two_stage"
        so = plan.sort_order[0]

        def _sorted(a, pad):
            return torch.from_numpy(
                np.concatenate([a, np.full(1, pad, a.dtype)])[so]
            ).to(dev)

        ids_s, cts_s, seg_s = _sorted(ids, 0), _sorted(cts, 0), _sorted(seg, 0)
        # the plan's live slots, from the host copy: the kernels' cost
        live = int(np.count_nonzero(cts))
        nb, tb = plan.nb, plan.tb
        lids = torch.from_numpy(plan.lids[0, 0]).to(dev)
        bv = torch.from_numpy(plan.block_vtile[0, 0]).to(dev)
        seg_b = seg_s.reshape(nb, 1, tb)
        cts_b = cts_s.reshape(nb, 1, tb)
        d_pad = fused_d_pad(d_max)
        geometry = dict(n_vtiles=plan.n_vtiles, nb=nb, vt=plan.vt, tb=tb,
                        shard_v=v, live=live)
        if fused:  # the fused kernel's doc stream: the packed tokens
            doc_toks = [torch.from_numpy(a).to(dev) for a in (ids, cts, seg)]

        def sweep(n_wk, n_dk):
            inv_denom = 1.0 / (n_wk.sum(dim=1) + (eta * v - v))
            if fused:
                docf = torch.zeros((k, d_pad), dtype=torch.float32, device=dev)
                docf[:, :d_max] = (n_dk + (alpha - 1.0)).T
                nwk_new, ndk_new = em_sweep_fused(
                    n_wk, docf, inv_denom, lids, seg_b, cts_b, bv, *doc_toks,
                    d_pad=d_pad, eta_m1=eta - 1.0, **geometry,
                )
                return nwk_new, ndk_new[:d_max]
            # two-stage: phi by plain gathers, then the scatter kernel
            term = n_wk[:, ids_s.long()].T + (eta - 1.0)            # [T, k]
            doc = (n_dk + (alpha - 1.0))[seg_s.long()]              # [T, k]
            phi = term * (doc * inv_denom)
            phi = phi / (phi.sum(dim=-1, keepdim=True) + 1e-30)
            wphi = (cts_s[:, None] * phi).contiguous()
            ndk_new = torch.zeros_like(n_dk).index_add_(0, seg_s.long(), wphi)
            nwk_new = scatter_add_vtiles(wphi, lids, bv, **geometry)
            return nwk_new, ndk_new

        def loglik(n_wk, n_dk):
            return packed_log_likelihood(
                n_wk, n_dk, ids_s, cts_s, seg_s, alpha=alpha, eta=eta, v=v)

        return _Layout(sweep, loglik, *self._local(slot, d_max, k))

    def _padded_sweep(self, rows, d_max, v, k, alpha, eta):
        """The padded layout on one device: one [B, L] batch per bucket of
        ``em_padded_shape``, the buckets' docs in consecutive n_dk rows.
        A sweep is the JAX package's ``_em_edge_pass`` per bucket in plain
        PyTorch: every bucket reads the same N_wk, and their partials sum
        to the next one.  The N_wk partials add the live slots only: a pad
        slot (id 0, weight 0) would add exactly 0, through same-address
        atomics on the card."""
        dev = self.device
        self.last_sweep = "padded"
        slot = np.zeros(len(rows), np.int64)
        buckets = []
        off = 0
        for width, idxs in em_padded_shape(rows, self.params.bucket_by_length):
            batch = batch_from_rows([rows[i] for i in idxs], row_len=width,
                                    device=dev)
            ids_b = batch.token_ids.long()
            wts_b = batch.token_weights
            live = torch.nonzero(wts_b.reshape(-1)).squeeze(1)
            seg_b = torch.arange(len(idxs), device=dev).repeat_interleave(
                width)
            buckets.append((off, ids_b, wts_b, live, ids_b.reshape(-1)[live],
                            seg_b))
            slot[idxs] = np.arange(off, off + len(idxs))
            off += len(idxs)

        def sweep(n_wk, n_dk):
            n_wk_t = n_wk.T.contiguous()                            # [V, k]
            denom = n_wk.sum(dim=1) + (eta * v - v)                 # [k]
            acc = torch.zeros((v, k), dtype=torch.float32, device=dev)
            n_dk_new = []
            for off, ids_b, wts_b, live, live_ids, _ in buckets:
                doc_f = n_dk[off:off + ids_b.shape[0]] + (alpha - 1.0)
                phi = (n_wk_t[ids_b] + (eta - 1.0)) * (doc_f / denom)[:, None]
                phi = phi / (phi.sum(dim=-1, keepdim=True) + 1e-30)
                wphi = wts_b[..., None] * phi                       # [B, L, k]
                n_dk_new.append(wphi.sum(dim=1))
                acc.index_add_(0, live_ids, wphi.reshape(-1, k)[live])
            return acc.T.contiguous(), torch.cat(n_dk_new)

        # one evaluation a bucket, under the JAX package's label of its
        # per-bucket evaluator
        bucket_ll = telemetry.instrument_dispatch(
            "sharded_eval.em_log_likelihood",
            lambda n_wk, n_dk, ids_b, wts_b, seg_b: packed_log_likelihood(
                n_wk, n_dk, ids_b.reshape(-1), wts_b.reshape(-1), seg_b,
                alpha=alpha, eta=eta, v=v))

        def loglik(n_wk, n_dk):
            return sum(bucket_ll(n_wk, n_dk[off:off + ids_b.shape[0]], ids_b,
                                 wts_b, seg_b)
                       for off, ids_b, wts_b, _, _, seg_b in buckets)

        return _Layout(sweep, loglik, *self._local(slot, d_max, k))

    def _packed_grid(self, rows, v, v_pad, k, alpha, eta):
        """The packed layout on the grid (JAX ``make_em_packed_runner``):
        rank (d, m) holds data shard d's docs and N_dk rows, and the
        vocabulary columns [m * shard_v, (m+1) * shard_v) of N_wk.  The
        scatter plan covers every (data, model) pair of
        ``packed_shard_plan``; this rank sweeps its own pair's segment.

        Fused (d_max <= 512 a shard): the kernel on the pair's tokens,
        with a doc stream of the pair's tokens in shard-local columns;
        N_wk' sums over "data", N_dk' over "model" (each token is swept by
        one rank).  Two-stage: phi over the data shard's whole sorted axis
        from ``gather_model_rows`` (phi is the same on every model shard,
        so N_dk' needs no collective), then the scatter kernel on the
        rank's own segment, summed over "data"."""
        g, dev = self.grid, self.device
        n_data, d, m = g.data_shards, g.d, g.m
        ids_t, cts_t, seg_t, slot, d_max = packed_shard_plan(rows, n_data)
        shard_v = v_pad // g.model_shards
        plan = plan_em_scatter(ids_t, cts_t, g.model_shards, shard_v)
        fused = fused_eligible(d_max)
        self.last_sweep = "fused" if fused else "two_stage"
        nb, tb, vt = plan.nb, plan.tb, plan.vt
        so = plan.sort_order[d]

        def _sorted(a):  # the data shard's sorted axis, model segments
            return np.concatenate([a[d], np.zeros(1, a.dtype)])[so]

        own = slice(m * nb * tb, (m + 1) * nb * tb)
        # the rank's own live slots, from the host copy: the kernels' cost
        live = int(np.count_nonzero(_sorted(cts_t)[own]))
        ids_s, cts_s, seg_s = (torch.from_numpy(_sorted(a)).to(dev)
                               for a in (ids_t, cts_t, seg_t))
        lids = torch.from_numpy(plan.lids[d, m]).to(dev)
        bv = torch.from_numpy(plan.block_vtile[d, m]).to(dev)
        seg_b = seg_s[own].reshape(nb, 1, tb)
        cts_b = cts_s[own].reshape(nb, 1, tb)
        geometry = dict(n_vtiles=plan.n_vtiles, nb=nb, vt=vt, tb=tb,
                        shard_v=shard_v, live=live)
        d_pad = fused_d_pad(d_max)
        if fused:
            doc_toks = doc_stream(lids, seg_b, cts_b, bv, vt)
        # the log-likelihood reads the data shard's tokens in doc order
        ids_p, cts_p, seg_p = (torch.from_numpy(a[d]).to(dev)
                               for a in (ids_t, cts_t, seg_t))
        mask = shard_col_mask(g, shard_v, v, dev)

        def sweep(n_wk, n_dk):
            inv_denom = 1.0 / (model_row_sum(g, n_wk) + (eta * v - v))
            if fused:
                docf = torch.zeros((k, d_pad), dtype=torch.float32, device=dev)
                docf[:, :d_max] = (n_dk + (alpha - 1.0)).T
                nwk_p, ndk_p = em_sweep_fused(
                    n_wk, docf, inv_denom, lids, seg_b, cts_b, bv, *doc_toks,
                    d_pad=d_pad, eta_m1=eta - 1.0, **geometry,
                )
                return psum_data(g, nwk_p), psum_model(g, ndk_p[:d_max])
            term = gather_model_rows(g, n_wk, ids_s) + (eta - 1.0)  # [T, k]
            doc = (n_dk + (alpha - 1.0))[seg_s.long()]              # [T, k]
            phi = term * (doc * inv_denom)
            phi = phi / (phi.sum(dim=-1, keepdim=True) + 1e-30)
            wphi = (cts_s[:, None] * phi).contiguous()
            ndk_new = torch.zeros_like(n_dk).index_add_(0, seg_s.long(), wphi)
            return (psum_data(g, scatter_add_vtiles(wphi[own], lids, bv,
                                                    **geometry)),
                    ndk_new)

        def loglik(n_wk, n_dk):
            # JAX make_em_packed_loglik: pad columns masked out of N_k
            n_k = masked_row_sum(g, n_wk, mask)
            phi_w = (gather_model_rows(g, n_wk, ids_p) + (eta - 1.0)) / (
                n_k + (eta * v - v))
            theta = (n_dk + (alpha - 1.0)) / (
                n_dk.sum(dim=-1, keepdim=True) + k * (alpha - 1.0))
            tok = (phi_w * theta[seg_p.long()]).sum(dim=-1)
            safe = torch.where(tok > 0, tok, torch.ones_like(tok))
            return psum_data(g, (cts_p * torch.log(safe)).sum().reshape(1))[0]

        def put(n_wk, n_dk):
            layout_ndk = np.zeros((n_data * d_max, k), np.float32)
            layout_ndk[slot] = n_dk
            cols = np.ascontiguousarray(n_wk[:, m * shard_v:(m + 1) * shard_v])
            return (torch.as_tensor(cols, dtype=torch.float32).to(dev),
                    torch.from_numpy(
                        layout_ndk[d * d_max:(d + 1) * d_max]).to(dev))

        return _Layout(
            sweep, loglik, put, lambda n_wk: fetch_global(g, n_wk, "model"),
            lambda n_dk: fetch_global(g, n_dk, "data")[slot],
            lambda n_wk: model_handoff(g, n_wk, v))

    def _padded_grid(self, rows, v, v_pad, k, alpha, eta):
        """The padded layout on the grid: each bucket's docs padded to a
        multiple of the data shards and cut into one block a data shard
        (``data_shard_rows``); a sweep is ``_em_edge_pass`` on each of this
        rank's blocks (token rows by ``gather_model_rows``, the N_wk
        partial by ``scatter_add_model_shard``), the partials summed over
        the buckets, then over "data" (one ``psum_data`` a sweep).  Plain
        PyTorch, as in the JAX package: this path has no kernel."""
        g, dev = self.grid, self.device
        shard_v = v_pad // g.model_shards
        self.last_sweep = "padded"
        buckets = []
        off = 0
        for width, idxs in em_padded_shape(rows, self.params.bucket_by_length):
            batch, lo, hi = data_shard_rows(g, [rows[i] for i in idxs], width,
                                            dev)
            ids_b = batch.token_ids.long()
            wts_b = batch.token_weights
            live = torch.nonzero(wts_b.reshape(-1)).squeeze(1)
            buckets.append((off, idxs, lo, hi, ids_b, wts_b, live))
            off += ids_b.shape[0]
        n_rows = off
        em_ll = make_sharded_em_log_likelihood(g, alpha=alpha, eta=eta,
                                               vocab_size=v)

        def sweep(n_wk, n_dk):
            denom = model_row_sum(g, n_wk) + (eta * v - v)          # [k]
            acc = n_wk.new_zeros(k, shard_v)
            n_dk_new = []
            for off, _, _, _, ids_b, wts_b, live in buckets:
                doc_f = n_dk[off:off + ids_b.shape[0]] + (alpha - 1.0)
                term = gather_model_rows(g, n_wk, ids_b) + (eta - 1.0)
                phi = term * (doc_f / denom)[:, None]               # [B, L, k]
                phi = phi / (phi.sum(dim=-1, keepdim=True) + 1e-30)
                wphi = wts_b[..., None] * phi
                n_dk_new.append(wphi.sum(dim=1))
                acc += scatter_add_model_shard(
                    g, ids_b.reshape(-1)[live], wphi.reshape(-1, k)[live],
                    shard_v)
            return psum_data(g, acc), torch.cat(n_dk_new)

        def loglik(n_wk, n_dk):
            return sum(em_ll(n_wk, n_dk[off:off + ids_b.shape[0]], ids_b, wts_b)
                       for off, _, _, _, ids_b, wts_b, _ in buckets)

        def put(n_wk, n_dk):
            local = np.zeros((n_rows, k), np.float32)
            for off, idxs, lo, hi, _, _, _ in buckets:
                local[off:off + hi - lo] = n_dk[idxs[lo:hi]]
            cols = np.ascontiguousarray(n_wk[:, g.m * shard_v:
                                             (g.m + 1) * shard_v])
            return (torch.as_tensor(cols, dtype=torch.float32).to(dev),
                    torch.from_numpy(local).to(dev))

        def get_ndk(n_dk):
            full = np.zeros((len(rows), k), np.float32)
            for off, idxs, _, _, ids_b, _, _ in buckets:
                block = n_dk[off:off + ids_b.shape[0]]
                full[idxs] = fetch_global(g, block, "data")[:len(idxs)]
            return full

        return _Layout(
            sweep, loglik, put, lambda n_wk: fetch_global(g, n_wk, "model"),
            get_ndk, lambda n_wk: model_handoff(g, n_wk, v))

    def fit(
        self,
        rows: Sequence[Tuple[np.ndarray, np.ndarray]],
        vocab: List[str],
        verbose: bool = False,
        max_iterations: Optional[int] = None,
    ) -> LDAModel:
        p = self.params
        dev = self.device
        grid = self.grid
        n_iters = p.max_iterations if max_iterations is None else max_iterations
        k, n, v = p.k, len(rows), len(vocab)
        alpha, eta = p.resolved_alpha(), p.resolved_eta()
        shards = 1 if grid is None else grid.model_shards
        v_pad = -(-v // shards) * shards
        padded = em_layout(rows, p.token_layout, p.bucket_by_length) == "padded"
        if v <= 0 or (padded and n == 0):
            raise ValueError("empty corpus or vocabulary")

        # the 1x1 packed layout: the init's draw order on every layout
        ids, cts, seg, packed_slot, d_max = packed_plan(rows)
        if grid is not None:
            build = self._padded_grid if padded else self._packed_grid
            layout = build(rows, v, v_pad, k, alpha, eta)
        elif padded:
            layout = self._padded_sweep(rows, d_max, v, k, alpha, eta)
        else:
            layout = self._packed_sweep(ids, cts, seg, packed_slot, d_max, v,
                                        k, alpha, eta)
        self.last_layout = "padded" if padded else "packed"

        ckpt_path = (
            os.path.join(p.checkpoint_dir, "em_state.npz")
            if p.checkpoint_dir else None
        )
        start_it = 0
        if agree_checkpoint_exists(ckpt_path):
            st = load_train_state(ckpt_path, require=("n_wk", "n_dk"))
            if st["n_wk"].shape != (k, v_pad) or st["n_dk"].shape != (n, k):
                raise ValueError(
                    f"checkpoint shapes n_wk{st['n_wk'].shape}/"
                    f"n_dk{st['n_dk'].shape} do not match this run "
                    f"({(k, v_pad)}/{(n, k)}): topology or params differ"
                )
            start_it = st["step"]
            n_wk, n_dk = layout.put(st["n_wk"], st["n_dk"])
        else:
            # one draw for every layout and grid: the 1x1 packed layout's,
            # its doc rows moved into corpus order
            w0, d0 = self._init_counts(ids, cts, seg, d_max, v, k, p.seed)
            w0 = w0.numpy()
            if v_pad != v:
                w0 = np.pad(w0, ((0, 0), (0, v_pad - v)))
            n_wk, n_dk = layout.put(w0, d0.numpy()[packed_slot])

        # the JAX package's label of this layout's wait
        sync_label = ("em_packed" if not padded
                      else "em_verbose" if verbose else "em_chunk")
        per_iter = verbose or p.record_iteration_times
        interval = 1 if per_iter else (
            max(1, p.checkpoint_interval) if ckpt_path else max(1, n_iters)
        )

        def chunk(n_wk, n_dk, m):
            for _ in range(m):
                n_wk, n_dk = layout.sweep(n_wk, n_dk)
            return n_wk, n_dk

        # one dispatch a chunk of m sweeps, under the JAX package's label
        # of the layout's runner (its verbose padded fit steps each bucket)
        run = telemetry.instrument_dispatch(
            "em.chunk_runner" if padded and not verbose
            else "em.bucket_step" if padded else "em.packed_chunk", chunk)
        timer = IterationTimer()
        it = start_it
        dispatches = 0
        while it < n_iters:
            m = min(interval - (it % interval), n_iters - it)
            timer.start()
            n_wk, n_dk = run(n_wk, n_dk, m)
            dispatches += 1
            telemetry.device_sync(n_wk, sync_label)
            timer.stop()
            timer.split_last(m)
            if verbose and is_coordinator():
                print(f"EM iter {it}: {timer.times[-1]:.4f}s ({self.last_sweep})")
            it += m
            if ckpt_path and it % max(1, p.checkpoint_interval) == 0:
                # collective fetches on every rank; one writer
                n_wk_host = layout.get_nwk(n_wk)
                n_dk_host = layout.get_ndk(n_dk)
                if is_coordinator():
                    save_train_state(ckpt_path, it, n_wk=n_wk_host,
                                     n_dk=n_dk_host)
        loglik = (layout.loglik if padded else telemetry.instrument_dispatch(
            "em.packed_loglik", layout.loglik))
        self.last_log_likelihood = float(loglik(n_wk, n_dk))
        if telemetry.enabled():
            telemetry.emit_fit(
                "em", timer.times, kind=timer.kind, start_iteration=start_it,
                log_likelihood=self.last_log_likelihood,
                layout=self.last_layout, sweep=self.last_sweep,
                cells=(em_padded_cells(rows, p.bucket_by_length) if padded
                       else int(len(ids))),
                dispatches=dispatches, k=k, vocab_width=v, docs=n,
            )
        if p.keep_doc_topic_counts:
            self.last_doc_topic_counts = layout.get_ndk(n_dk)
        return LDAModel(
            lam=layout.lam(n_wk),
            vocab=list(vocab),
            alpha=np.full((k,), alpha, np.float32),
            eta=float(eta),
            gamma_shape=p.gamma_shape,
            iteration_times=list(timer.times),
            iteration_times_kind=timer.kind,
            algorithm="em",
            step=start_it + len(timer.times),
            device=str(dev),
        )
