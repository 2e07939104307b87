"""Vocabulary-sharded scoring and evaluation over a ``ProcessGrid``.

Every lambda-derived tensor stays [k, V/s] on each rank, as in training
(the JAX package's ``models/sharded_eval.py``):

  * ``make_sharded_topic_inference``: the scoring gamma fixed point.  A
    batch's token rows of exp(E[log beta]) come from
    ``gather_model_rows_bkl`` (one ``psum_model``) in the [B, k, L] layout
    of the padded E-step kernel, which iterates on each rank's block of
    documents (``ops.estep``: ``csrc/estep.cu`` on the card, its plain
    version on the CPU);
  * ``make_sharded_log_likelihood``: the gamma fixed point and Hoffman's
    bound in one pass over one gather of lambda's rows;
  * ``make_sharded_em_log_likelihood``: ``DistributedLDAModel
    .logLikelihood`` with N_wk gathered per token;
  * ``make_sharded_top_terms``: ``describeTopics`` candidates, each shard's
    top-n of its own columns.

Each factory returns a function of this rank's shards: lambda [k, V_pad/s]
(zero-padded to a model-shard multiple; pad columns are masked out of
every vocabulary-wide sum) and its data shard's block of documents.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import telemetry
from ..ops.estep import gamma_fixed_point_bkl
from ..ops.lda_math import dirichlet_expectation, dirichlet_expectation_sharded
from ..parallel.collectives import (
    gather_model_rows,
    gather_model_rows_bkl,
    psum_data,
    psum_model,
)
from ..parallel.mesh import ProcessGrid
from .base import LDAModel

__all__ = [
    "make_sharded_em_log_likelihood",
    "make_sharded_log_likelihood",
    "make_sharded_top_terms",
    "make_sharded_topic_inference",
    "masked_row_sum",
    "shard_col_mask",
]

_LAM_FLOOR = LDAModel._LAM_FLOOR


def shard_col_mask(grid: ProcessGrid, shard_v: int, vocab_size: int,
                   device) -> torch.Tensor:
    """[shard_v] bool: which of this shard's columns are real vocabulary."""
    off = grid.m * shard_v
    return (off + torch.arange(shard_v, device=device)) < vocab_size


def masked_row_sum(grid: ProcessGrid, table: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """True row sums [k] of a vocabulary-sharded table, pads masked out."""
    return psum_model(
        grid, torch.where(mask[None], table, table.new_zeros(())).sum(-1))


def _scalar_sum(grid: ProcessGrid, x: torch.Tensor, axis) -> torch.Tensor:
    return axis(grid, x.reshape(1))[0]


def make_sharded_topic_inference(
    grid: ProcessGrid,
    *,
    alpha: np.ndarray,
    vocab_size: int,
    max_inner: int = 100,
    tol: float = 1e-3,
) -> Callable[..., torch.Tensor]:
    """``LocalLDAModel.topicDistribution`` on the grid.  Returned fn:
    (lam shard [k, V_pad/s], ids [B, L], weights [B, L], gamma0 [B, k] of
    this rank's block) -> normalized gamma [B, k], uniform for empty
    docs."""

    def infer(lam_shard, ids, wts, gamma0):
        alpha_t = torch.as_tensor(alpha, dtype=torch.float32,
                                  device=lam_shard.device)
        k = lam_shard.shape[0]
        mask = shard_col_mask(grid, lam_shard.shape[-1], vocab_size,
                              lam_shard.device)
        lam_f = lam_shard.clamp(min=_LAM_FLOOR)
        row_sum = masked_row_sum(grid, lam_f, mask)
        eb_shard = torch.exp(dirichlet_expectation_sharded(lam_f, row_sum))
        eb_tok = gather_model_rows_bkl(grid, eb_shard, ids)   # [B, k, L]
        gamma = gamma_fixed_point_bkl(eb_tok, wts.contiguous(), alpha_t,
                                      gamma0.contiguous(), max_inner, tol)
        dist = gamma / gamma.sum(dim=-1, keepdim=True)
        nonempty = wts.sum(dim=-1, keepdim=True) > 0
        return torch.where(nonempty, dist, torch.full_like(dist, 1.0 / k))

    return telemetry.instrument_dispatch("sharded_eval.topic_inference",
                                         infer)


def make_sharded_log_likelihood(
    grid: ProcessGrid,
    *,
    alpha: np.ndarray,
    eta: float,
    vocab_size: int,
    max_inner: int = 100,
    tol: float = 1e-3,
) -> Callable[..., torch.Tensor]:
    """The variational bound (``logLikelihood``) on the grid: one gather
    of the batch's lambda rows serves the fixed point (exp space) and the
    token term (log space).  Document terms sum over "data", the topic
    terms over "model" with pad columns masked.  Returned fn: (lam shard,
    ids, weights, gamma0 of this rank's block, corpus_size, batch_docs)
    -> the bound, the same scalar on every rank.  Pad docs (weights 0)
    converge to gamma == alpha, where their terms cancel exactly."""
    v = vocab_size

    def loglik(lam_shard, ids, wts, gamma0, corpus_size, batch_docs):
        dev = lam_shard.device
        alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
        mask = shard_col_mask(grid, lam_shard.shape[-1], v, dev)
        lam_f = lam_shard.clamp(min=_LAM_FLOOR)
        row_sum = masked_row_sum(grid, lam_f, mask)                # [k]
        lam_tok = gather_model_rows_bkl(grid, lam_f, ids)          # [B, k, L]
        elog_tok = (torch.digamma(lam_tok.clamp(min=_LAM_FLOOR))
                    - torch.digamma(row_sum)[None, :, None])
        gamma = gamma_fixed_point_bkl(torch.exp(elog_tok), wts.contiguous(),
                                      alpha_t, gamma0.contiguous(),
                                      max_inner, tol)
        elog_theta = dirichlet_expectation(gamma)                  # [B, k]
        lse = torch.logsumexp(elog_tok + elog_theta[:, :, None], dim=1)
        doc = (wts * lse).sum()
        doc = doc + ((alpha_t - gamma) * elog_theta).sum()
        doc = doc + (torch.lgamma(gamma) - torch.lgamma(alpha_t)).sum()
        doc = doc + (torch.lgamma(alpha_t.sum())
                     - torch.lgamma(gamma.sum(dim=-1))).sum()
        doc = _scalar_sum(grid, doc, psum_data)
        doc = doc * (corpus_size / max(batch_docs, 1.0))

        eta_t = torch.tensor(float(eta), dtype=torch.float32, device=dev)
        elog_beta = dirichlet_expectation_sharded(lam_f, row_sum)
        topic = torch.where(
            mask[None],
            (eta_t - lam_f) * elog_beta + torch.lgamma(lam_f)
            - torch.lgamma(eta_t),
            lam_f.new_zeros(())).sum()
        topic = _scalar_sum(grid, topic, psum_model)
        topic = topic + (torch.lgamma(eta_t * v)
                         - torch.lgamma(row_sum)).sum()
        return doc + topic

    return telemetry.instrument_dispatch("sharded_eval.log_likelihood",
                                         loglik)


def make_sharded_em_log_likelihood(
    grid: ProcessGrid,
    *,
    alpha: float,
    eta: float,
    vocab_size: int,
) -> Callable[..., torch.Tensor]:
    """``DistributedLDAModel.logLikelihood`` on the grid, N_wk gathered
    per token.  Returned fn: (n_wk shard [k, V_pad/s], n_dk [B, k], ids
    [B, L], weights [B, L] of this rank's block) -> the sum over every
    rank's docs, the same scalar on every rank."""
    v = vocab_size

    def loglik(n_wk_shard, n_dk, ids, wts):
        mask = shard_col_mask(grid, n_wk_shard.shape[-1], v,
                              n_wk_shard.device)
        n_k = masked_row_sum(grid, n_wk_shard, mask)               # [k]
        nwk_tok = gather_model_rows(grid, n_wk_shard, ids)         # [B, L, k]
        phi_w = (nwk_tok + (eta - 1.0)) / (n_k + (eta * v - v))
        theta = (n_dk + (alpha - 1.0)) / (
            n_dk.sum(dim=-1, keepdim=True) + n_dk.shape[-1] * (alpha - 1.0))
        tok = torch.einsum("blk,bk->bl", phi_w, theta)
        safe = torch.where(tok > 0, tok, torch.ones_like(tok))
        return _scalar_sum(grid, (wts * torch.log(safe)).sum(), psum_data)

    return telemetry.instrument_dispatch("sharded_eval.em_log_likelihood",
                                         loglik)


def make_sharded_top_terms(
    grid: ProcessGrid, vocab_size: int, n: int
) -> Callable[[torch.Tensor], Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``describeTopics(n)`` candidates without a full [k, V] table: each
    shard takes the top n of its own columns (pads masked to -inf).
    Returned fn: lam shard -> (ids [k, s*n] global term ids, values [k,
    s*n], true topic totals [k]), on every rank's host.  Candidates join
    over the shards as a gather: each rank writes its n columns of a
    zero-filled [k, s*n] table and one ``psum_model`` fills it in."""

    def top(lam_shard):
        shard_v = lam_shard.shape[-1]
        mask = shard_col_mask(grid, shard_v, vocab_size, lam_shard.device)
        masked = torch.where(mask[None], lam_shard,
                             lam_shard.new_full((), float("-inf")))
        k_eff = min(n, shard_v)
        vals, idx = torch.topk(masked, k_eff, dim=-1)
        totals = masked_row_sum(grid, lam_shard.clamp(min=0.0), mask)
        k, s = lam_shard.shape[0], grid.model_shards
        all_ids = torch.zeros((k, s * k_eff), dtype=torch.int64,
                              device=lam_shard.device)
        all_vals = lam_shard.new_zeros(k, s * k_eff)
        cols = slice(grid.m * k_eff, (grid.m + 1) * k_eff)
        all_ids[:, cols] = idx + grid.m * shard_v
        all_vals[:, cols] = vals
        return (psum_model(grid, all_ids).cpu().numpy(),
                psum_model(grid, all_vals).cpu().numpy(),
                totals.cpu().numpy())

    return top
