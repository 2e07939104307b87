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
resumes from ``<checkpoint_dir>/em_state.npz`` (n_wk [k, V], n_dk [n, k]
in corpus order, step) when one is present: the JAX package's checkpoint
format, whichever layout wrote it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..ops.emscatter import plan_em_scatter, scatter_add_vtiles
from ..ops.emsweep import em_sweep_fused, fused_d_pad, fused_eligible
from ..ops.sparse import batch_from_rows, bucket_indices_by_length, next_pow2
from ..utils.timing import IterationTimer
from .base import LDAModel
from .persistence import load_train_state, save_train_state, train_state_valid

__all__ = ["EMLDA", "em_layout", "em_padded_cells", "em_padded_shape",
           "packed_plan", "packed_log_likelihood"]

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


class EMLDA:
    """Estimator for the EM path: ``fit(rows, vocab) -> LDAModel`` with
    the EM auto priors alpha = 50/k + 1, eta = 1.1."""

    def __init__(self, params: Params, device="cuda") -> None:
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
        if params.model_shards != 1 or params.data_shards not in (None, 1):
            raise ValueError("the port's EM fit runs on one device")
        self.params = params
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

    def _packed_sweep(self, ids, cts, seg, d_max, v, k, alpha, eta):
        """(sweep, loglik) closures over the packed layout, reordered once
        into the scatter plan's vocab-sorted blocks: the fused kernel for
        a doc axis of at most 512 slots, else the two-stage sweep."""
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
        nb, tb = plan.nb, plan.tb
        lids = torch.from_numpy(plan.lids[0, 0]).to(dev)
        bv = torch.from_numpy(plan.block_vtile[0, 0]).to(dev)
        seg_b = seg_s.reshape(nb, 1, tb)
        cts_b = cts_s.reshape(nb, 1, tb)
        d_pad = fused_d_pad(d_max)
        geometry = dict(n_vtiles=plan.n_vtiles, nb=nb, vt=plan.vt, tb=tb,
                        shard_v=v)
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

        return sweep, loglik

    def _padded_sweep(self, rows, v, k, alpha, eta):
        """(sweep, loglik, slot) over the padded layout: one [B, L] batch
        per bucket of ``em_padded_shape``, the buckets' docs in
        consecutive n_dk rows (``slot[d]`` is doc d's row).  A sweep is the
        JAX package's ``_em_edge_pass`` per bucket in plain PyTorch: every
        bucket reads the same N_wk, and their partials sum to the next
        one.  The N_wk partials add the live slots only: a pad slot (id 0,
        weight 0) would add exactly 0, through same-address atomics on
        the card."""
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

        def loglik(n_wk, n_dk):
            return sum(
                packed_log_likelihood(
                    n_wk, n_dk[off:off + ids_b.shape[0]], ids_b.reshape(-1),
                    wts_b.reshape(-1), seg_b, alpha=alpha, eta=eta, v=v)
                for off, ids_b, wts_b, _, _, seg_b in buckets)

        return sweep, loglik, slot

    def fit(
        self,
        rows: Sequence[Tuple[np.ndarray, np.ndarray]],
        vocab: List[str],
        verbose: bool = False,
        max_iterations: Optional[int] = None,
    ) -> LDAModel:
        p = self.params
        dev = self.device
        n_iters = p.max_iterations if max_iterations is None else max_iterations
        k, n, v = p.k, len(rows), len(vocab)
        alpha, eta = p.resolved_alpha(), p.resolved_eta()
        padded = em_layout(rows, p.token_layout, p.bucket_by_length) == "padded"
        if v <= 0 or (padded and n == 0):
            raise ValueError("empty corpus or vocabulary")

        # n_dk lives on the device as [d_max, k] rows in the layout's doc
        # order; slot[d] is corpus doc d's row, on either layout
        ids, cts, seg, packed_slot, d_max = packed_plan(rows)
        if padded:
            sweep, loglik, slot = self._padded_sweep(rows, v, k, alpha, eta)
        else:
            sweep, loglik = self._packed_sweep(ids, cts, seg, d_max, v, k,
                                               alpha, eta)
            slot = packed_slot
        self.last_layout = "padded" if padded else "packed"

        ckpt_path = (
            os.path.join(p.checkpoint_dir, "em_state.npz")
            if p.checkpoint_dir else None
        )
        start_it = 0
        if ckpt_path and train_state_valid(ckpt_path):
            st = load_train_state(ckpt_path, require=("n_wk", "n_dk"))
            if st["n_wk"].shape != (k, v) or st["n_dk"].shape != (n, k):
                raise ValueError(
                    f"checkpoint shapes n_wk{st['n_wk'].shape}/"
                    f"n_dk{st['n_dk'].shape} do not match this run "
                    f"({(k, v)}/{(n, k)})"
                )
            start_it = st["step"]
            n_wk = torch.as_tensor(st["n_wk"], dtype=torch.float32).to(dev)
            layout_ndk = np.zeros((d_max, k), np.float32)
            layout_ndk[slot] = st["n_dk"]
            n_dk = torch.from_numpy(layout_ndk).to(dev)
        else:
            # one draw for both layouts: a padded fit starts from the
            # packed fit's counts, its rows moved into bucket order
            n_wk, n_dk = self._init_counts(ids, cts, seg, d_max, v, k, p.seed)
            if padded:
                layout_ndk = torch.zeros_like(n_dk)
                layout_ndk[torch.from_numpy(slot)] = n_dk[
                    torch.from_numpy(packed_slot)]
                n_dk = layout_ndk
            n_wk, n_dk = n_wk.to(dev), n_dk.to(dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        per_iter = verbose or p.record_iteration_times
        interval = 1 if per_iter else (
            max(1, p.checkpoint_interval) if ckpt_path else max(1, n_iters)
        )
        timer = IterationTimer()
        it = start_it
        while it < n_iters:
            m = min(interval - (it % interval), n_iters - it)
            timer.start()
            for _ in range(m):
                n_wk, n_dk = sweep(n_wk, n_dk)
            sync()
            timer.stop()
            timer.split_last(m)
            if verbose:
                print(f"EM iter {it}: {timer.times[-1]:.4f}s ({self.last_sweep})")
            it += m
            if ckpt_path and it % max(1, p.checkpoint_interval) == 0:
                save_train_state(
                    ckpt_path, it, n_wk=n_wk.cpu().numpy(),
                    n_dk=n_dk.cpu().numpy()[slot],
                )
        self.last_log_likelihood = float(loglik(n_wk, n_dk))
        if p.keep_doc_topic_counts:
            self.last_doc_topic_counts = n_dk.cpu().numpy()[slot]
        return LDAModel(
            lam=n_wk.cpu().numpy(),
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
