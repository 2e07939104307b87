"""Vocabulary construction and count vectorization (host, single process).

Corpus-wide term counts, vocabulary = top ``vocab_size`` terms by
descending count (ties broken by term, ascending, for reproducibility),
vocabulary index = rank, then per-document sparse count vectors with
sorted ids.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "build_vocab",
    "count_terms",
    "count_vector",
    "count_vectors",
    "counter_to_sparse",
]


def counter_to_sparse(c: Counter) -> Tuple[np.ndarray, np.ndarray]:
    """{id: count} -> (sorted int32 ids, float32 counts)."""
    if not c:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    ids = np.fromiter(sorted(c.keys()), dtype=np.int32, count=len(c))
    return ids, np.asarray([c[int(i)] for i in ids], dtype=np.float32)


def count_terms(docs_tokens: Iterable[Sequence[str]]) -> Counter:
    """Corpus-wide term occurrence counts."""
    c: Counter = Counter()
    for toks in docs_tokens:
        c.update(toks)
    return c


def build_vocab(
    term_counts: Counter, vocab_size: int
) -> Tuple[List[str], Dict[str, int]]:
    """Top-``vocab_size`` terms by descending count; index = rank."""
    ranked = sorted(term_counts.items(), key=lambda kv: (-kv[1], kv[0]))
    vocab = [t for t, _ in ranked[:vocab_size]]
    return vocab, {t: i for i, t in enumerate(vocab)}


def count_vector(
    tokens: Sequence[str], term_to_id: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """One document's sparse count vector; out-of-vocab tokens drop."""
    c: Counter = Counter()
    for t in tokens:
        i = term_to_id.get(t)
        if i is not None:
            c[i] += 1
    return counter_to_sparse(c)


def count_vectors(
    docs_tokens: Sequence[Sequence[str]],
    term_to_id: Dict[str, int],
    drop_empty: bool = True,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], List[int]]:
    """Vectorize a corpus: (rows, kept original indices); empty documents
    drop unless ``drop_empty=False``."""
    out, kept = [], []
    for j, toks in enumerate(docs_tokens):
        ids, vals = count_vector(toks, term_to_id)
        if len(ids) == 0 and drop_empty:
            continue
        out.append((ids, vals))
        kept.append(j)
    return out, kept
