"""LDA variational math in PyTorch: the E-step gamma fixed point, the
scoring and evaluation entry points built on it, and the random inits.

``topic_inference`` scores a padded [B, L] batch through the E-step kernel
(``estep.gamma_fixed_point``: the CUDA kernel on the card, its plain
version on the CPU).  ``topic_inference_segments`` scores a token-packed
batch with whole-batch convergence in plain PyTorch, or with per-document
(``freeze``) convergence: on the card through the per-document kernel
(``segments``), whose bytes follow each document alone, on the CPU in
plain PyTorch.  ``infer_gamma`` and ``approx_bound`` are the evaluation
pair behind ``LDAModel.log_likelihood``.  Pad slots (weight 0) add exactly
0 everywhere.  Gamma starts at all ones, or at Gamma(shape, 1/shape)
draws from an explicit ``torch.Generator`` (``seeded_generator``), as
does lambda (``init_lambda``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .estep import gamma_fixed_point
from .sparse import DocTermBatch

__all__ = [
    "approx_bound",
    "dirichlet_expectation",
    "dirichlet_expectation_sharded",
    "infer_gamma",
    "init_gamma",
    "init_lambda",
    "seeded_generator",
    "segments_distribution_plain",
    "gamma_fixed_point_batch",
    "gamma_fixed_point_segments",
    "token_sstats_factors_bkl",
    "token_sstats_factors_segments",
    "topic_inference",
    "topic_inference_segments",
]

# Hoffman's 1e-100 underflows to 0 in float32; 1e-30 is a normal float32.
_PHI_EPS = 1e-30


def dirichlet_expectation(alpha: torch.Tensor) -> torch.Tensor:
    """E[log X] for X ~ Dir(alpha), rows are distributions."""
    return torch.digamma(alpha) - torch.digamma(
        alpha.sum(dim=-1, keepdim=True)
    )


def dirichlet_expectation_sharded(
    shard: torch.Tensor, row_sum: torch.Tensor
) -> torch.Tensor:
    """``dirichlet_expectation`` of a vocabulary-sharded table [k, V/s]
    whose true row sums [k] were reduced across the shards
    (``parallel.model_row_sum``): the full [k, V] table never exists."""
    return torch.digamma(shard) - torch.digamma(row_sum)[..., None]


def seeded_generator(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integer tuple
    ``key`` (numpy's ``SeedSequence`` mixes it into one 63-bit seed)."""
    seed = np.random.SeedSequence([int(x) for x in key]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    return gen


def init_lambda(
    generator: torch.Generator, k: int, vocab_size: int,
    gamma_shape: float = 100.0, device="cpu",
) -> torch.Tensor:
    """lambda ~ Gamma(gammaShape, 1/gammaShape), shape [k, V]: MLlib's
    init, drawn on the generator's device and moved to ``device``."""
    shape = torch.full((k, vocab_size), float(gamma_shape),
                       dtype=torch.float32, device=generator.device)
    return (torch._standard_gamma(shape, generator=generator)
            / gamma_shape).to(device)


def init_gamma(
    generator: Optional[torch.Generator],
    n_docs: int,
    k: int,
    gamma_shape: float = 100.0,
    device="cpu",
) -> torch.Tensor:
    """All ones without a generator, else Gamma(shape, 1/shape) draws."""
    if generator is None:
        return torch.ones((n_docs, k), dtype=torch.float32, device=device)
    shape = torch.full((n_docs, k), float(gamma_shape), dtype=torch.float32,
                       device=generator.device)
    return (torch._standard_gamma(shape, generator=generator)
            / gamma_shape).to(device)


def gamma_fixed_point_batch(
    eb: torch.Tensor,        # [B, L, k] gathered exp(E[log beta])
    cts: torch.Tensor,       # [B, L]
    alpha: torch.Tensor,
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int,
    tol: float,
) -> Tuple[torch.Tensor, int]:
    """The whole-batch gamma iteration (Hoffman eq. 2-4): every doc
    iterates until the worst per-doc mean|delta gamma| < tol or
    max_inner.  Returns (gamma, iterations run)."""
    gamma = gamma0
    it = 0
    while it < max_inner:
        et = torch.exp(dirichlet_expectation(gamma))           # [B, k]
        phinorm = torch.einsum("blk,bk->bl", eb, et) + _PHI_EPS
        g_new = alpha + et * torch.einsum("blk,bl->bk", eb, cts / phinorm)
        worst = (g_new - gamma).abs().mean(dim=-1).max()
        gamma = g_new
        it += 1
        if float(worst) < tol:
            break
    return gamma, it


def gamma_fixed_point_segments(
    eb_tok: torch.Tensor,    # [T, k] gathered exp(E[log beta]) per token
    cts: torch.Tensor,       # [T] token weights (0 = pad slot)
    seg: torch.Tensor,       # [T] document position in [0, B)
    alpha: torch.Tensor,
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int,
    tol: float,
    freeze: bool = False,
    reduce_fn=None,
    with_iters: bool = False,
):
    """The gamma fixed point over a token-packed batch: (gamma, iterations
    run).  ``freeze`` switches to per-document convergence: a row stops
    updating the iteration its own mean|delta gamma| drops below ``tol``,
    so its result depends on its own tokens only.  ``reduce_fn`` combines
    the per-doc sums of a token axis split over ranks (``psum_data``) each
    iteration, so gamma stays the same on every rank.  ``with_iters`` adds
    the iterations each row was updated [B]."""
    b = gamma0.shape[0]
    seg_l = seg.long()

    def step(gamma):
        et = torch.exp(dirichlet_expectation(gamma))           # [B, k]
        phinorm = (eb_tok * et[seg_l]).sum(-1) + _PHI_EPS      # [T]
        contrib = gamma.new_zeros(b, gamma.shape[1]).index_add_(
            0, seg_l, eb_tok * (cts / phinorm)[:, None]
        )
        if reduce_fn is not None:
            contrib = reduce_fn(contrib)
        return alpha + et * contrib

    gamma = gamma0
    frozen = torch.zeros(b, dtype=torch.bool, device=gamma0.device)
    iters = torch.zeros(b, dtype=torch.int64, device=gamma0.device)
    it = 0
    while it < max_inner:
        g_new = step(gamma)
        change = (g_new - gamma).abs().mean(dim=-1)
        it += 1
        if with_iters:
            iters += ~frozen
        if freeze:
            gamma = torch.where(frozen[:, None], gamma, g_new)
            frozen = frozen | (change < tol)
            worst = torch.where(frozen, torch.zeros_like(change), change).max()
        else:
            gamma = g_new
            worst = change.max()
        if float(worst) < tol:
            break
    return (gamma, it, iters) if with_iters else (gamma, it)


def token_sstats_factors_segments(
    eb_tok: torch.Tensor,    # [T, k]
    cts: torch.Tensor,       # [T]
    seg: torch.Tensor,       # [T]
    gamma: torch.Tensor,     # [B, k]
) -> torch.Tensor:
    """Final per-token responsibility factors of a token-packed batch,
    vals [T, k]: scatter-added over token ids (after ``* eb_tok``) they
    are the sufficient statistics times exp(E[log beta])."""
    et_tok = torch.exp(dirichlet_expectation(gamma))[seg.long()]   # [T, k]
    phinorm = (eb_tok * et_tok).sum(-1) + _PHI_EPS                # [T]
    return et_tok * (cts / phinorm)[:, None]


def token_sstats_factors_bkl(
    eb_tok: torch.Tensor,    # [B, k, L] gathered exp(E[log beta])
    cts: torch.Tensor,       # [B, L]
    gamma: torch.Tensor,     # [B, k]
) -> torch.Tensor:
    """The same factors in the padded [B, k, L] layout of the E-step
    kernel: vals [B, k, L], scatter-added over token ids they are the raw
    sufficient statistics."""
    et_k = torch.exp(dirichlet_expectation(gamma))[:, :, None]     # [B, k, 1]
    phinorm = (eb_tok * et_k).sum(dim=1) + _PHI_EPS               # [B, L]
    return et_k * (cts / phinorm)[:, None]                        # [B, k, L]


def _normalize(gamma: torch.Tensor, nonempty: torch.Tensor) -> torch.Tensor:
    k = gamma.shape[-1]
    dist = gamma / gamma.sum(dim=-1, keepdim=True)
    return torch.where(nonempty[:, None], dist, torch.full_like(dist, 1.0 / k))


def topic_inference(
    batch: DocTermBatch,
    exp_elog_beta: torch.Tensor,   # [k, V]
    alpha: torch.Tensor,
    gamma0: torch.Tensor,          # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
) -> torch.Tensor:
    """``LocalLDAModel.topicDistribution`` over a padded batch: normalized
    gamma [B, k]; empty docs get the uniform distribution."""
    cts = batch.token_weights
    eb = exp_elog_beta.T[batch.token_ids.long()]              # [B, L, k]
    gamma = gamma_fixed_point(eb, cts, alpha, gamma0, max_inner, tol)
    return _normalize(gamma, cts.sum(dim=-1) > 0)


def infer_gamma(
    batch: DocTermBatch,
    exp_elog_beta: torch.Tensor,   # [k, V]
    alpha: torch.Tensor,
    gamma0: torch.Tensor,          # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
) -> torch.Tensor:
    """Gamma only (no sufficient statistics), through the E-step kernel:
    the evaluation path of ``LDAModel.log_likelihood``."""
    eb = exp_elog_beta.T[batch.token_ids.long()]              # [B, L, k]
    return gamma_fixed_point(eb, batch.token_weights, alpha, gamma0,
                             max_inner, tol)


def approx_bound(
    batch: DocTermBatch,
    gamma: torch.Tensor,     # [B, k]
    lam: torch.Tensor,       # [k, V]
    alpha,                   # [k] or scalar
    eta: float,
    corpus_size: float,
    batch_docs: float,
) -> torch.Tensor:
    """Hoffman's variational lower bound on log p(docs), the basis of
    ``logLikelihood`` / ``logPerplexity``: document terms scaled by
    corpus_size / batch_docs, the topic term counted once."""
    ids, cts = batch.token_ids.long(), batch.token_weights
    k = gamma.shape[-1]
    elog_theta = dirichlet_expectation(gamma)                 # [B, k]
    elog_beta = dirichlet_expectation(lam)                    # [k, V]
    eb = elog_beta.T[ids]                                     # [B, L, k]
    lse = torch.logsumexp(eb + elog_theta[:, None, :], dim=-1)
    score = (cts * lse).sum()
    alpha_v = torch.broadcast_to(
        torch.as_tensor(alpha, dtype=torch.float32, device=gamma.device), (k,))
    score = score + ((alpha_v - gamma) * elog_theta).sum()
    score = score + (torch.lgamma(gamma) - torch.lgamma(alpha_v)).sum()
    score = score + (
        torch.lgamma(alpha_v.sum()) - torch.lgamma(gamma.sum(dim=-1))
    ).sum()
    score = score * (corpus_size / max(batch_docs, 1.0))
    v = lam.shape[-1]
    eta_t = torch.tensor(float(eta), dtype=torch.float32, device=lam.device)
    score = score + ((eta - lam) * elog_beta).sum()
    score = score + (torch.lgamma(lam) - torch.lgamma(eta_t)).sum()
    score = score + (
        torch.lgamma(eta_t * v) - torch.lgamma(lam.sum(dim=-1))
    ).sum()
    return score


def topic_inference_segments(
    eb_tok: torch.Tensor,    # [T, k]
    cts: torch.Tensor,       # [T]
    seg: torch.Tensor,       # [T]
    alpha: torch.Tensor,
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    freeze: bool = False,
    offsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``topic_inference`` over a token-packed batch.  With ``freeze`` on
    CUDA tensors the per-document kernel (``segments.
    topic_inference_segments``) computes it from the docs' int32
    ``offsets`` [B + 1] (docs contiguous from slot 0), so each row's bytes
    follow from its own document alone; everywhere else the plain code
    (``segments_distribution_plain``) runs."""
    if freeze and eb_tok.device.type == "cuda":
        if offsets is None:
            raise ValueError("per-document convergence on the card takes "
                             "the docs' offsets")
        from .segments import topic_inference_segments as per_doc

        return per_doc(eb_tok, cts, offsets, alpha, gamma0, max_inner, tol)
    return segments_distribution_plain(eb_tok, cts, seg, alpha, gamma0,
                                       max_inner, tol, freeze=freeze)


def segments_distribution_plain(
    eb_tok: torch.Tensor,    # [T, k]
    cts: torch.Tensor,       # [T]
    seg: torch.Tensor,       # [T]
    alpha,
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    freeze: bool = False,
    with_iters: bool = False,
):
    """The packed fixed point in plain PyTorch, normalized (empty docs
    uniform); with ``with_iters``, also each doc's iterations [B]."""
    b = gamma0.shape[0]
    gamma, _, iters = gamma_fixed_point_segments(
        eb_tok, cts, seg, alpha, gamma0, max_inner, tol, freeze=freeze,
        with_iters=True,
    )
    mass = cts.new_zeros(b).index_add_(0, seg.long(), cts)
    dist = _normalize(gamma, mass > 0)
    return (dist, iters) if with_iters else dist
