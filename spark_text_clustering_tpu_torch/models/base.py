"""``LDAModel``: the topic model both optimizers produce.

``lam`` [k, V] holds topic-word pseudo-counts (EM's N_wk or online VB's
lambda); rows, normalized, are the topics.  The vocabulary is part of the
model.  ``topic_distribution`` scores documents on ``device`` ("cuda" by
default): padded power-of-two length buckets through the E-step kernel,
or one token-packed batch in plain PyTorch.  ``log_likelihood`` and
``log_perplexity`` evaluate the variational bound with gamma from the
E-step kernel.  With ``grid=`` (a ``parallel.ProcessGrid``), scoring,
evaluation and ``describe_topics`` run vocabulary-sharded on the grid's
ranks (``sharded_eval``): lambda [k, V_pad/s] a rank, docs split over
the data shards, every rank getting the whole result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lda_math import (
    approx_bound,
    dirichlet_expectation,
    infer_gamma,
    init_gamma,
    topic_inference,
    topic_inference_segments,
)
from ..ops.segments import pack_offsets
from ..ops.sparse import (
    DocTermBatch,
    batch_from_rows,
    bucket_by_length,
    bucket_indices_by_length,
    next_pow2,
)

__all__ = ["LDAModel"]


@dataclass
class LDAModel:
    """Topic model: ``lam`` [k, V] pseudo-counts, vocabulary, priors."""

    lam: np.ndarray                    # [k, V] float32
    vocab: List[str]
    alpha: np.ndarray                  # [k] docConcentration
    eta: float                         # topicConcentration
    gamma_shape: float = 100.0
    iteration_times: List[float] = field(default_factory=list)
    iteration_times_kind: str = "per_iteration"
    algorithm: str = "online"
    step: int = 0
    device: str = "cuda"
    # lambda's shard and the sharded functions, per grid (models are not
    # changed after a fit)
    _grid_cache: dict = field(default_factory=dict, init=False, repr=False,
                              compare=False)

    # EM counts can be exact 0; flooring them at 1e-30 keeps digamma
    # finite and gives exp(E[log beta]) == 0 there, as the JAX package does.
    _LAM_FLOOR = 1e-30

    @property
    def k(self) -> int:
        return int(self.lam.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.lam.shape[1])

    # ---- topics --------------------------------------------------------
    def topics_matrix(self) -> np.ndarray:
        """Row-normalized topic-term distributions [k, V] (float64)."""
        lam = np.asarray(self.lam, np.float64)
        return lam / lam.sum(axis=1, keepdims=True)

    # Above this vocabulary width ``describe_topics(grid=...)`` ranks each
    # shard's columns on its rank; below it the host float64 argsort is
    # kept (the JAX package's rule for a host-resident lambda)
    _DEVICE_TOPK_MIN_V = 1_000_000

    def describe_topics(
        self, max_terms_per_topic: int = 10, grid=None
    ) -> List[List[Tuple[int, float]]]:
        """Per topic, the top-n (term_id, weight), weights normalized by the
        topic total (host float64, stable order on ties).  With ``grid`` and
        V >= ``_DEVICE_TOPK_MIN_V``, each vocabulary shard proposes its own
        top n in float32 (``make_sharded_top_terms``) and the host merges
        k x (shards * n) candidates."""
        n = min(max_terms_per_topic, self.vocab_size)
        if grid is not None and self.vocab_size >= self._DEVICE_TOPK_MIN_V:
            fn = self._grid_fn("top_terms", grid, n=n)
            ids, vals, totals = fn(self._lam_on_grid(grid))
            vals, totals = vals.astype(np.float64), totals.astype(np.float64)
            out = []
            for t in range(ids.shape[0]):
                # pad-column candidates of narrow shards carry -inf
                live = np.nonzero(np.isfinite(vals[t]))[0]
                order = live[np.argsort(-vals[t][live], kind="stable")][:n]
                out.append([(int(ids[t][j]), float(vals[t][j] / totals[t]))
                            for j in order])
            return out
        out = []
        for row in self.topics_matrix():
            top = np.argsort(-row, kind="stable")[:max_terms_per_topic]
            out.append([(int(i), float(row[i])) for i in top])
        return out

    def describe_topics_terms(
        self, max_terms_per_topic: int = 10, grid=None
    ) -> List[List[Tuple[str, float]]]:
        return [
            [(self.vocab[i], w) for i, w in topic]
            for topic in self.describe_topics(max_terms_per_topic, grid=grid)
        ]

    # ---- the grid --------------------------------------------------------
    def _lam_on_grid(self, grid, smoothed: bool = False) -> torch.Tensor:
        """This rank's shard [k, V_pad/s] of lambda (of ``_lam_for_bound``
        when ``smoothed``), zero-padded to a model-shard multiple, on the
        grid's device; made once per grid."""
        key = ("lam", id(grid), smoothed)
        hit = self._grid_cache.get(key)
        if hit is None or hit[0] is not grid:
            lam = self._lam_for_bound() if smoothed else np.asarray(
                self.lam, np.float32)
            s, v = grid.model_shards, self.vocab_size
            shard_v = -(-v // s)
            cols = np.zeros((self.k, shard_v), np.float32)
            part = lam[:, grid.m * shard_v:(grid.m + 1) * shard_v]
            cols[:, :part.shape[1]] = part
            hit = (grid, torch.from_numpy(cols).to(grid.device))
            self._grid_cache[key] = hit
        return hit[1]

    def _grid_fn(self, kind: str, grid, **kw):
        """``sharded_eval.make_sharded_<kind>`` for this model, made once
        per grid and arguments."""
        key = (kind, id(grid), tuple(sorted(kw.items())))
        hit = self._grid_cache.get(key)
        if hit is None or hit[0] is not grid:
            from . import sharded_eval

            factory = getattr(sharded_eval, f"make_sharded_{kind}")
            if kind == "top_terms":
                fn = factory(grid, self.vocab_size, **kw)
            else:
                alpha = np.broadcast_to(
                    np.asarray(self.alpha, np.float32), (self.k,)).copy()
                fn = factory(grid, alpha=alpha, vocab_size=self.vocab_size,
                             **kw)
            hit = (grid, fn)
            self._grid_cache[key] = hit
        return hit[1]

    def _run_on_grid(self, grid, fn, rows, gamma0, *extra):
        """``fn(lam shard, ids, weights, gamma0, *extra)`` on this rank's
        block of ``rows`` (one padded batch; pad docs start at gamma 1)."""
        from ..parallel.collectives import data_shard_rows

        max_nnz = max((len(i) for i, _ in rows), default=0)
        width = max(8, next_pow2(max_nnz))
        batch, lo, hi = data_shard_rows(grid, rows, width, grid.device)
        g0 = gamma0.new_ones(batch.token_ids.shape[0], self.k)
        g0[:hi - lo] = gamma0[lo:hi]
        return fn(batch.token_ids, batch.token_weights, g0, *extra)

    def _topic_distribution_grid(self, rows, max_inner, tol, seed, grid):
        from ..parallel.collectives import fetch_global

        infer = self._grid_fn("topic_inference", grid, max_inner=max_inner,
                              tol=tol)
        lam = self._lam_on_grid(grid)
        if isinstance(rows, DocTermBatch):
            # one padded batch as it is, its pad rows and slots included:
            # each rank scores its block of rows at the batch's width
            n = rows.num_docs
            local = self._run_on_grid(
                grid, lambda *a: infer(lam, *a),
                list(zip(rows.token_ids.cpu().numpy(),
                         rows.token_weights.cpu().numpy())),
                self._gamma0(n, seed, grid.device))
            return fetch_global(grid, local, "data")[:n]
        gamma0 = self._gamma0(len(rows), seed, grid.device)
        out = np.zeros((len(rows), self.k), np.float32)
        for _, idxs in sorted(bucket_indices_by_length(rows).items()):
            local = self._run_on_grid(
                grid, lambda *a: infer(lam, *a), [rows[i] for i in idxs],
                gamma0[torch.as_tensor(idxs, device=grid.device)])
            out[idxs] = fetch_global(grid, local, "data")[:len(idxs)]
        return out

    # ---- inference -----------------------------------------------------
    def _exp_elog_beta(self, dev: torch.device) -> torch.Tensor:
        lam = torch.as_tensor(np.asarray(self.lam, np.float32), device=dev)
        return torch.exp(dirichlet_expectation(lam.clamp(min=self._LAM_FLOOR)))

    def _gamma0(self, n: int, seed: Optional[int], dev) -> torch.Tensor:
        """Initial gamma for docs 0..n-1 in corpus order (all ones, or
        Gamma draws from a CPU generator seeded with ``seed``), so a doc's
        start does not depend on its bucket."""
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return init_gamma(gen, n, self.k, self.gamma_shape).to(dev)

    def topic_distribution(
        self,
        docs: Union[DocTermBatch, Sequence[Tuple[np.ndarray, np.ndarray]]],
        max_inner: int = 100,
        tol: float = 1e-3,
        seed: Optional[int] = None,
        layout: str = "auto",
        convergence: str = "batch",
        device=None,
        grid=None,
    ) -> np.ndarray:
        """Per-doc posterior topic mixture [n, k].

        ``docs`` is a row list, or one padded ``DocTermBatch`` (the pinned
        batch of a streaming trigger), which is scored as it is: one
        E-step over all its rows, pad rows included, every row returned
        (its gamma inits drawn for ``num_docs`` rows; "per_doc" refuses
        a batch, as in the JAX package).  ``layout``: "padded" scores per power-of-two length bucket through
        the E-step kernel; "packed" scores the whole corpus as one flat
        token batch; "auto" takes padded on the card and packed on the
        CPU.  ``convergence``: "batch" iterates until the worst doc of the
        dispatch (a tile of the kernel, or the packed batch) converges;
        "per_doc" freezes each doc at its own convergence, so its result
        depends on its own tokens only (packed layout; on the card the
        per-document kernel, whose bytes do not depend on the batch).
        ``grid`` scores on the grid's ranks: per length bucket, each rank's block of docs
        through the E-step kernel against its vocabulary shard (layout
        and ``device`` do not apply; "per_doc" is refused, as in the JAX
        package)."""
        if convergence not in ("batch", "per_doc"):
            raise ValueError(
                f"convergence must be 'batch' or 'per_doc', got {convergence!r}"
            )
        if layout not in ("auto", "padded", "packed"):
            raise ValueError(f"unknown layout {layout!r}")
        is_batch = isinstance(docs, DocTermBatch)
        if convergence == "per_doc":
            if grid is not None:
                raise ValueError(
                    "convergence='per_doc' does not support grid scoring "
                    "(the sharded path has no frozen fixed point)")
            if is_batch:
                raise ValueError(
                    "convergence='per_doc' scores row lists (it owns the "
                    "packed layout); pass the (ids, weights) rows")
        if grid is not None:
            docs = docs if is_batch else list(docs)
            if not is_batch and not docs:
                return np.zeros((0, self.k), np.float32)
            return self._topic_distribution_grid(docs, max_inner, tol, seed,
                                                 grid)
        dev = resolve_device(self.device if device is None else device)
        alpha = torch.as_tensor(np.asarray(self.alpha, np.float32), device=dev)
        if is_batch:
            batch = DocTermBatch(docs.token_ids.to(dev),
                                 docs.token_weights.to(dev))
            dist = topic_inference(
                batch, self._exp_elog_beta(dev), alpha,
                self._gamma0(batch.num_docs, seed, dev),
                max_inner=max_inner, tol=tol)
            return dist.cpu().numpy()
        rows = list(docs)
        if not rows:
            return np.zeros((0, self.k), np.float32)
        eb = self._exp_elog_beta(dev)
        gamma0 = self._gamma0(len(rows), seed, dev)
        use_packed = convergence == "per_doc" or layout == "packed" or (
            layout == "auto" and dev.type == "cpu"
        )
        if use_packed:
            return self._topic_distribution_packed(
                rows, eb, alpha, gamma0, max_inner, tol,
                freeze=convergence == "per_doc",
            )
        out = np.zeros((len(rows), self.k), np.float32)
        for _, (batch, idxs) in bucket_by_length(rows, device=dev).items():
            sel = torch.as_tensor(idxs, device=dev)
            dist = topic_inference(
                batch, eb, alpha, gamma0[sel], max_inner=max_inner, tol=tol
            )
            out[idxs] = dist.cpu().numpy()
        return out

    def _topic_distribution_packed(
        self, rows, eb, alpha, gamma0, max_inner, tol, freeze=False
    ) -> np.ndarray:
        lens = [len(i) for i, _ in rows]
        t_pad = next_pow2(max(8, sum(lens)))
        flat_i = np.zeros(t_pad, np.int64)
        flat_c = np.zeros(t_pad, np.float32)
        seg = np.zeros(t_pad, np.int64)
        o = 0
        for d, (ids, wts) in enumerate(rows):
            flat_i[o:o + len(ids)] = ids
            flat_c[o:o + len(ids)] = wts
            seg[o:o + len(ids)] = d
            o += len(ids)
        dev = eb.device
        eb_tok = eb.T[torch.from_numpy(flat_i).to(dev)]          # [T, k]
        dist = topic_inference_segments(
            eb_tok, torch.from_numpy(flat_c).to(dev),
            torch.from_numpy(seg).to(dev), alpha, gamma0,
            max_inner=max_inner, tol=tol, freeze=freeze,
            offsets=torch.from_numpy(pack_offsets(lens)).to(dev),
        )
        return dist.cpu().numpy()

    # ---- evaluation ----------------------------------------------------
    def _lam_for_bound(self) -> np.ndarray:
        """Lambda the bound is evaluated at: online lambdas as they are
        (floored at 1e-30); EM counts, which hold exact zeros, at the
        posterior Dirichlet parameter N_wk + eta."""
        lam = np.asarray(self.lam, np.float32)
        if self.algorithm == "em":
            return lam + np.float32(self.eta)
        return np.maximum(lam, np.float32(self._LAM_FLOOR))

    def log_likelihood(
        self,
        docs: Union[DocTermBatch, Sequence[Tuple[np.ndarray, np.ndarray]]],
        seed: Optional[int] = None,
        device=None,
        grid=None,
    ) -> float:
        """Variational lower bound on log p(docs) (MLlib
        ``logLikelihood``), over one padded batch: ``docs`` as it is when
        it is a ``DocTermBatch`` (pad rows included, gamma inits drawn for
        ``num_docs`` rows), else the batch of its rows; the corpus size is
        the count of rows with weight.  With ``grid``, vocabulary-sharded
        on the grid's ranks, each rank taking its block of the rows at
        the batch's width."""
        is_batch = isinstance(docs, DocTermBatch)
        if grid is not None:
            rows = (list(zip(docs.token_ids.cpu().numpy(),
                             docs.token_weights.cpu().numpy()))
                    if is_batch else list(docs))
            n_docs = float(sum(1 for _, w in rows if np.sum(w) > 0))
            fn = self._grid_fn("log_likelihood", grid, eta=float(self.eta))
            lam = self._lam_on_grid(grid, smoothed=self.algorithm == "em")
            bound = self._run_on_grid(
                grid, lambda *a: fn(lam, *a), rows,
                self._gamma0(len(rows), seed, grid.device), n_docs, n_docs)
            return float(bound)
        dev = resolve_device(self.device if device is None else device)
        if is_batch:
            batch = DocTermBatch(docs.token_ids.to(dev),
                                 docs.token_weights.to(dev))
        else:
            batch = batch_from_rows(list(docs), device=dev)
        n_docs = float((batch.token_weights.sum(-1) > 0).sum())
        alpha = torch.as_tensor(np.asarray(self.alpha, np.float32), device=dev)
        lam_b = torch.from_numpy(self._lam_for_bound()).to(dev)
        gamma = infer_gamma(
            batch, torch.exp(dirichlet_expectation(lam_b)), alpha,
            self._gamma0(batch.num_docs, seed, dev),
        )
        return float(approx_bound(batch, gamma, lam_b, alpha, float(self.eta),
                                  corpus_size=n_docs, batch_docs=n_docs))

    def log_perplexity(self, docs, device=None, grid=None) -> float:
        """-bound / total token mass (MLlib ``logPerplexity``)."""
        if isinstance(docs, DocTermBatch):
            tokens = float(docs.token_weights.sum())
        else:
            docs = list(docs)
            tokens = float(sum(np.asarray(w, np.float32).sum()
                               for _, w in docs))
        return -self.log_likelihood(docs, device=device, grid=grid) / max(
            tokens, 1.0)

    # ---- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        from .persistence import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "LDAModel":
        from .persistence import load_model

        return load_model(path, device=device)
