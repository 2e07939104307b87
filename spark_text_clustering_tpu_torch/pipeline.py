"""Estimator/Transformer stages of the port: tokens -> rows -> TF-IDF ->
LDA, on a plain dict dataset with the JAX package's keys:

    tokens : List[List[str]]        preprocessed token lists
    rows   : List[(ids, weights)]   sparse doc-term rows
    vocab  : List[str]              vocabulary
    model  : LDAModel | NMFModel    after an LDA stage
    topic_distribution : np.ndarray [n, k]

``IDF`` and ``LDA`` run on ``device`` ("cuda" by default).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Params
from .device import resolve_device
from .ops.sparse import batch_from_rows, bucket_by_length
from .ops.tfidf import doc_freq, idf_from_df, idf_transform
from .utils.vocab import build_vocab, count_terms, count_vectors

__all__ = [
    "CountVectorizer",
    "CountVectorizerModel",
    "IDF",
    "IDFModel",
    "LDA",
    "LDAModelTransformer",
    "NMFEstimator",
]


class CountVectorizerModel:
    def __init__(self, vocab: List[str]):
        self.vocab = vocab
        self._t2i = {t: i for i, t in enumerate(vocab)}

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        out["rows"], _ = count_vectors(ds["tokens"], self._t2i, drop_empty=False)
        out["vocab"] = self.vocab
        return out


class CountVectorizer:
    """Frequency-ranked exact vocabulary from ``ds["tokens"]``."""

    def __init__(self, vocab_size: int = 2_900_000):
        self.vocab_size = vocab_size

    def fit(self, ds: Dict) -> CountVectorizerModel:
        vocab, _ = build_vocab(count_terms(ds["tokens"]), self.vocab_size)
        return CountVectorizerModel(vocab)


class IDFModel:
    def __init__(self, idf: np.ndarray, idf_floor: float, device="cuda"):
        self.idf = idf
        self.idf_floor = idf_floor
        self.device = device

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        rows = ds["rows"]
        if not rows:
            return out
        dev = resolve_device(self.device)
        weighted = idf_transform(
            batch_from_rows(rows, device=dev),
            torch.as_tensor(self.idf, device=dev),
            idf_floor=self.idf_floor,
        )
        w = weighted.token_weights.cpu().numpy()
        out["rows"] = [
            (np.asarray(i).copy(), w[r, : len(i)].copy())
            for r, (i, _) in enumerate(rows)
        ]
        return out


class IDF:
    """MLlib IDF(minDocFreq=2) with the reference's 0.0001 floor.  The df
    pass runs per power-of-two length bucket, so its memory is bounded by
    the largest bucket."""

    def __init__(self, min_doc_freq: int = 2, idf_floor: float = 0.0001,
                 device="cuda"):
        self.min_doc_freq = min_doc_freq
        self.idf_floor = idf_floor
        self.device = device

    def fit(self, ds: Dict) -> IDFModel:
        dev = resolve_device(self.device)
        rows = ds["rows"]
        v = len(ds["vocab"]) if ds.get("vocab") is not None else ds["num_features"]
        df = torch.zeros(v, dtype=torch.float32, device=dev)
        for _, (batch, _) in bucket_by_length(rows, device=dev).items():
            df += doc_freq(batch, v)
        # MLlib: m = number of vectors, empties included
        idf = idf_from_df(df, len(rows), self.min_doc_freq)
        return IDFModel(idf.cpu().numpy(), self.idf_floor, self.device)


class LDAModelTransformer:
    def __init__(self, model, log_likelihood: Optional[float] = None,
                 corpus_size: Optional[int] = None):
        self.model = model
        self.log_likelihood = log_likelihood
        self.corpus_size = corpus_size

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        out["model"] = self.model
        out["topic_distribution"] = self.model.topic_distribution(ds["rows"])
        return out


class LDA:
    """The LDA facade: EM, online VB on the tiles-resident path, or NMF
    (the estimator swap), by ``params.algorithm``."""

    def __init__(self, params: Params, device="cuda"):
        self.params = params
        self.device = device

    def fit(self, ds: Dict) -> LDAModelTransformer:
        from .models.em_lda import EMLDA
        from .models.nmf import NMF
        from .models.online_lda import OnlineLDA

        optimizers = {"em": EMLDA, "online": OnlineLDA, "nmf": NMF}
        if self.params.algorithm not in optimizers:
            raise ValueError(
                f"unknown algorithm {self.params.algorithm!r}; expected one "
                f"of {sorted(optimizers)}"
            )
        vocab = ds.get("vocab")
        if vocab is None:
            vocab = [f"h{i}" for i in range(ds["num_features"])]
        nonempty = [(i, w) for i, w in ds["rows"] if len(i) > 0]
        opt = optimizers[self.params.algorithm](self.params, device=self.device)
        model = opt.fit(nonempty, vocab)
        return LDAModelTransformer(
            model, log_likelihood=getattr(opt, "last_log_likelihood", None),
            corpus_size=len(nonempty),
        )


class NMFEstimator(LDA):
    """The estimator swap: the LDA facade pinned to ``algorithm="nmf"``,
    so scoring and report code downstream need not know which factorizer
    made the topics."""

    def __init__(self, params: Params, device="cuda"):
        super().__init__(params.replace(algorithm="nmf"), device=device)
