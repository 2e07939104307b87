"""``LDAModel``: the topic model both optimizers produce.

``lam`` [k, V] holds topic-word pseudo-counts (EM's N_wk or online VB's
lambda); rows, normalized, are the topics.  The vocabulary is part of the
model.  ``topic_distribution`` scores documents on ``device`` ("cuda" by
default): padded power-of-two length buckets through the E-step kernel,
or one token-packed batch in plain PyTorch.  ``log_likelihood`` and
``log_perplexity`` evaluate the variational bound with gamma from the
E-step kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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
from ..ops.sparse import batch_from_rows, bucket_by_length, next_pow2

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

    def describe_topics(
        self, max_terms_per_topic: int = 10
    ) -> List[List[Tuple[int, float]]]:
        """Per topic, the top-n (term_id, weight), weights normalized by the
        topic total (host float64, stable order on ties)."""
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
        docs: Sequence[Tuple[np.ndarray, np.ndarray]],
        max_inner: int = 100,
        tol: float = 1e-3,
        seed: Optional[int] = None,
        layout: str = "auto",
        convergence: str = "batch",
        device=None,
    ) -> np.ndarray:
        """Per-doc posterior topic mixture [n, k].

        ``layout``: "padded" scores per power-of-two length bucket through
        the E-step kernel; "packed" scores the whole corpus as one flat
        token batch; "auto" takes padded on the card and packed on the
        CPU.  ``convergence``: "batch" iterates until the worst doc of the
        dispatch (a tile of the kernel, or the packed batch) converges;
        "per_doc" freezes each doc at its own convergence, so its result
        depends on its own tokens only (packed layout)."""
        if convergence not in ("batch", "per_doc"):
            raise ValueError(
                f"convergence must be 'batch' or 'per_doc', got {convergence!r}"
            )
        if layout not in ("auto", "padded", "packed"):
            raise ValueError(f"unknown layout {layout!r}")
        dev = resolve_device(self.device if device is None else device)
        rows = list(docs)
        if not rows:
            return np.zeros((0, self.k), np.float32)
        alpha = torch.as_tensor(np.asarray(self.alpha, np.float32), device=dev)
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
        docs: Sequence[Tuple[np.ndarray, np.ndarray]],
        seed: Optional[int] = None,
        device=None,
    ) -> float:
        """Variational lower bound on log p(docs) (MLlib
        ``logLikelihood``), over one padded batch of ``docs``."""
        dev = resolve_device(self.device if device is None else device)
        rows = list(docs)
        batch = batch_from_rows(rows, device=dev)
        n_docs = float((batch.token_weights.sum(-1) > 0).sum())
        alpha = torch.as_tensor(np.asarray(self.alpha, np.float32), device=dev)
        lam_b = torch.from_numpy(self._lam_for_bound()).to(dev)
        gamma = infer_gamma(
            batch, torch.exp(dirichlet_expectation(lam_b)), alpha,
            self._gamma0(len(rows), seed, dev),
        )
        return float(approx_bound(batch, gamma, lam_b, alpha, float(self.eta),
                                  corpus_size=n_docs, batch_docs=n_docs))

    def log_perplexity(self, docs, device=None) -> float:
        """-bound / total token mass (MLlib ``logPerplexity``)."""
        rows = list(docs)
        tokens = float(sum(np.asarray(w, np.float32).sum() for _, w in rows))
        return -self.log_likelihood(rows, device=device) / max(tokens, 1.0)

    # ---- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        from .persistence import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "LDAModel":
        from .persistence import load_model

        return load_model(path, device=device)
