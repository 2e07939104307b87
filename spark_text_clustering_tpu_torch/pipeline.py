"""Estimator/Transformer stages of the port: texts -> tokens -> rows ->
TF-IDF -> LDA, on a plain dict dataset with the JAX package's keys:

    texts  : List[str]              raw documents
    tokens : List[List[str]]        preprocessed token lists
    rows   : List[(ids, weights)]   sparse doc-term rows
    vocab  : List[str]              vocabulary (None after HashingTF)
    model  : LDAModel | NMFModel    after an LDA stage
    topic_distribution : np.ndarray [n, k]

Text stages run on the host (the native C++ library, or Python);
``IDF`` and ``LDA`` run on ``device`` ("cuda" by default), or on a
``grid`` of ranks that the caller shares between them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import telemetry
from .config import Params
from .device import resolve_device
from .ops.sparse import (
    batch_from_rows,
    bucket_by_length,
    bucket_indices_by_length,
)
from .ops.tfidf import (
    doc_freq,
    hashing_tf_rows,
    idf_from_df,
    idf_transform,
    make_doc_freq_sharded,
)
from .utils.vocab import build_vocab, count_terms, count_vectors

__all__ = [
    "CountVectorizer",
    "CountVectorizerModel",
    "Estimator",
    "HashingTF",
    "IDF",
    "IDFModel",
    "LDA",
    "LDAModelTransformer",
    "NMFEstimator",
    "Pipeline",
    "PipelineModel",
    "TextPreprocessor",
    "Transformer",
    "is_hashed_vocab",
    "make_vectorizer",
]


def is_hashed_vocab(vocab: Sequence[str]) -> bool:
    """True when a model's vocabulary is the synthetic ``h0..hN`` of the
    HashingTF path: scoring such a model hashes tokens instead of looking
    them up."""
    n = len(vocab)
    if n == 0:
        return False
    return all(vocab[i] == f"h{i}" for i in (0, n // 2, n - 1))


def make_vectorizer(vocab: Sequence[str]):
    """tokens -> sparse rows for scoring: count vectors over an exact
    vocabulary (the reference's BuildCountVector), murmur3 buckets over a
    hashed ``h0..hN`` one."""
    if is_hashed_vocab(vocab):
        n = len(vocab)
        return lambda tokens_lists: hashing_tf_rows(tokens_lists, n)
    cvm = CountVectorizerModel(list(vocab))
    return lambda tokens_lists: cvm.transform({"tokens": tokens_lists})["rows"]


class Transformer:
    def transform(self, ds: Dict) -> Dict:
        raise NotImplementedError


class Estimator:
    def fit(self, ds: Dict) -> Transformer:
        raise NotImplementedError


class TextPreprocessor(Transformer):
    """texts -> tokens: lemmatize, clean, tokenize, stop-filter, stem (the
    map side of the reference's BuildTFIDFVector).

    ``backend="native"`` runs the C++ library (``utils/native.py``, built
    with g++ on first use; documents in parallel over host cores) and
    raises when it does not build; ``"python"`` runs ``utils/textproc.py``,
    which needs nltk for its stemmer; ``"auto"`` takes the native library
    where it builds, else Python where nltk imports, else raises naming
    both.  Both give the same tokens.  ``last_backend`` names the one the
    last ``transform`` ran."""

    def __init__(
        self,
        stop_words: frozenset = frozenset(),
        lemmatize: bool = True,
        dedup_within_sentence: bool = True,
        fold_case: bool = True,
        backend: str = "auto",
    ) -> None:
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.stop_words = stop_words
        self.lemmatize = lemmatize
        self.dedup = dedup_within_sentence
        self.fold_case = fold_case
        self.backend = backend
        self.last_backend: Optional[str] = None

    def _resolve_backend(self) -> str:
        if self.backend == "python":
            return "python"
        from .utils import native

        try:
            native.load()
            return "native"
        except RuntimeError as exc:
            if self.backend == "native":
                raise
            why = exc
        try:
            import nltk.stem  # noqa: F401
        except ImportError:
            raise RuntimeError(
                f"no text backend: {why}; and the Python path needs nltk, "
                "which is not installed"
            ) from None
        return "python"

    def transform(self, ds: Dict) -> Dict:
        from .utils import native, textproc

        out = dict(ds)
        self.last_backend = self._resolve_backend()
        opts = dict(
            stop_words=self.stop_words,
            lemmatize=self.lemmatize,
            dedup_within_sentence=self.dedup,
            fold_case=self.fold_case,
        )
        if self.last_backend == "native":
            out["tokens"] = native.preprocess_documents(ds["texts"], **opts)
        else:
            out["tokens"] = [
                textproc.preprocess_document(t, **opts) for t in ds["texts"]
            ]
        return out


class HashingTF(Transformer):
    """Vocabulary-free featurization: murmur3 (seed 42) mod
    ``num_features``, Spark's HashingTF."""

    def __init__(self, num_features: int = 1 << 18):
        self.num_features = num_features

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        out["rows"] = hashing_tf_rows(ds["tokens"], self.num_features)
        out["vocab"] = None
        out["num_features"] = self.num_features
        return out


class CountVectorizerModel(Transformer):
    def __init__(self, vocab: List[str]):
        self.vocab = vocab
        self._t2i = {t: i for i, t in enumerate(vocab)}

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        out["rows"], _ = count_vectors(ds["tokens"], self._t2i, drop_empty=False)
        out["vocab"] = self.vocab
        return out


class CountVectorizer(Estimator):
    """Frequency-ranked exact vocabulary from ``ds["tokens"]``."""

    def __init__(self, vocab_size: int = 2_900_000):
        self.vocab_size = vocab_size

    def fit(self, ds: Dict) -> CountVectorizerModel:
        vocab, _ = build_vocab(count_terms(ds["tokens"]), self.vocab_size)
        return CountVectorizerModel(vocab)


class IDFModel(Transformer):
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


class IDF(Estimator):
    """MLlib IDF(minDocFreq=2) with the reference's 0.0001 floor.  The df
    pass runs per power-of-two length bucket, so its memory is bounded by
    the largest bucket.  With a ``grid`` (a ``parallel.ProcessGrid``) each
    rank counts its data shard's block of every bucket and the df sums
    over the data shards (``make_doc_freq_sharded``): the same df, bit for
    bit, on every rank and at every grid."""

    def __init__(self, min_doc_freq: int = 2, idf_floor: float = 0.0001,
                 device="cuda", grid=None):
        self.min_doc_freq = min_doc_freq
        self.idf_floor = idf_floor
        self.grid = grid
        self.device = device if grid is None else grid.device

    def fit(self, ds: Dict) -> IDFModel:
        dev = resolve_device(self.device)
        rows = ds["rows"]
        v = len(ds["vocab"]) if ds.get("vocab") is not None else ds["num_features"]
        df = torch.zeros(v, dtype=torch.float32, device=dev)
        if self.grid is not None:
            from .parallel.collectives import data_shard_rows

            df_fn = make_doc_freq_sharded(self.grid, v)
            for width, idxs in sorted(bucket_indices_by_length(rows).items()):
                block, _, _ = data_shard_rows(
                    self.grid, [rows[i] for i in idxs], width, dev)
                df += df_fn(block)
        else:
            for _, (batch, _) in bucket_by_length(rows, device=dev).items():
                df += doc_freq(batch, v)
        # MLlib: m = number of vectors, empties included
        idf = idf_from_df(df, len(rows), self.min_doc_freq)
        return IDFModel(idf.cpu().numpy(), self.idf_floor, self.device)


class LDAModelTransformer(Transformer):
    def __init__(self, model, log_likelihood: Optional[float] = None,
                 corpus_size: Optional[int] = None,
                 doc_topic_counts: Optional[np.ndarray] = None):
        self.model = model
        self.log_likelihood = log_likelihood
        self.corpus_size = corpus_size        # nonempty docs trained on
        # EM's N_dk [corpus_size, k] in corpus order (MLlib export), or None
        self.doc_topic_counts = doc_topic_counts

    def transform(self, ds: Dict) -> Dict:
        out = dict(ds)
        out["model"] = self.model
        out["topic_distribution"] = self.model.topic_distribution(ds["rows"])
        return out


class LDA(Estimator):
    """The LDA facade: EM, online VB, or NMF (the estimator swap), by
    ``params.algorithm``.  With a ``grid``, each of the three fits on
    it."""

    def __init__(self, params: Params, device="cuda", grid=None):
        self.params = params
        self.grid = grid
        self.device = device if grid is None else grid.device

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
        opt = optimizers[self.params.algorithm](self.params,
                                                device=self.device,
                                                grid=self.grid)
        model = opt.fit(nonempty, vocab)
        return LDAModelTransformer(
            model, log_likelihood=getattr(opt, "last_log_likelihood", None),
            corpus_size=len(nonempty),
            doc_topic_counts=getattr(opt, "last_doc_topic_counts", None),
        )


class NMFEstimator(LDA):
    """The estimator swap: the LDA facade pinned to ``algorithm="nmf"``,
    so scoring and report code downstream need not know which factorizer
    made the topics."""

    def __init__(self, params: Params, device="cuda", grid=None):
        super().__init__(params.replace(algorithm="nmf"), device=device,
                         grid=grid)


class PipelineModel(Transformer):
    def __init__(self, stages: Sequence[Transformer]):
        self.stages = list(stages)

    def transform(self, ds: Dict) -> Dict:
        # per-stage spans: wall time per transformer (no-ops when
        # telemetry is off)
        for s in self.stages:
            with telemetry.span(
                f"pipeline.transform.{type(s).__name__}", emit=False
            ):
                ds = s.transform(ds)
        return ds


class Pipeline(Estimator):
    """Fit estimators in sequence, passing transformed data downstream."""

    def __init__(self, stages: Sequence[object]):
        self.stages = list(stages)

    def fit(self, ds: Dict) -> PipelineModel:
        fitted: List[Transformer] = []
        last = len(self.stages) - 1
        for i, s in enumerate(self.stages):
            with telemetry.span(f"pipeline.fit.{type(s).__name__}"):
                t = s.fit(ds) if isinstance(s, Estimator) else s
                if i != last:
                    # the final model's transform output is unused here
                    ds = t.transform(ds)
            fitted.append(t)
        return PipelineModel(fitted)
