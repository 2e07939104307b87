"""Vocabulary construction and count vectorization (host).

Corpus-wide term counts, vocabulary = top ``vocab_size`` terms by
descending count (ties broken by term, ascending, for reproducibility),
vocabulary index = rank, then per-document sparse count vectors with
sorted ids.  Counter addition is associative, so the count shards across
host processes (``count_terms_parallel``) and across the ranks of a
``torch.distributed`` group (``merge_term_counts_multihost``) with the
serial count's result.  Nothing here imports torch at import time.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "build_vocab",
    "build_vocab_multihost",
    "count_terms",
    "count_terms_parallel",
    "count_vector",
    "count_vectors",
    "counter_to_sparse",
    "merge_term_counts_multihost",
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


def count_terms_parallel(
    docs_tokens: Sequence[Sequence[str]],
    num_workers: Optional[int] = None,
) -> Counter:
    """Sharded corpus-wide term counting: each of ``num_workers`` host
    processes counts a strided document shard and the partial Counters
    merge, so the result is identical to ``count_terms`` at any worker
    count.  Small corpora (under 16 documents a worker) count serially,
    where spawning would cost more than it saves."""
    docs = (
        docs_tokens
        if isinstance(docs_tokens, (list, tuple))
        else list(docs_tokens)
    )
    if num_workers is None:
        num_workers = min(os.cpu_count() or 1, 16)
    num_workers = min(num_workers, max(1, len(docs) // 16))
    if num_workers <= 1:
        return count_terms(docs)

    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    shards = [docs[w::num_workers] for w in range(num_workers)]
    total: Counter = Counter()
    try:
        # "spawn", not fork: the caller may hold CUDA state and live
        # threads that a forked child must not inherit
        with ProcessPoolExecutor(
            max_workers=num_workers, mp_context=mp.get_context("spawn")
        ) as ex:
            for part in ex.map(count_terms, shards):
                total.update(part)
    except (OSError, RuntimeError):
        return count_terms(docs)  # no process spawning here
    return total


def merge_term_counts_multihost(counts: Counter) -> Counter:
    """Merge per-rank term counters over the default ``torch.distributed``
    process group (the one ``parallel.ProcessGrid`` and ``run_grid``
    initialize; gloo on one card): one ``all_gather_object``, then the
    same merge in rank order on every rank, so every rank derives the
    same top-V.  Without an initialized group, or in a group of one,
    the counter comes back unchanged.  Collective: every rank calls it,
    each with the counts of its own documents only."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return counts
    world = dist.get_world_size()
    if world == 1:
        return counts
    parts: List[Optional[Dict[str, int]]] = [None] * world
    dist.all_gather_object(parts, dict(counts))
    merged: Counter = Counter()
    for part in parts:
        merged.update(part)
    return merged


def build_vocab_multihost(
    local_docs_tokens: Sequence[Sequence[str]],
    vocab_size: int,
    num_workers: Optional[int] = None,
) -> Tuple[List[str], Dict[str, int]]:
    """The vocabulary of the documents of every rank: each rank counts its
    own documents (in ``num_workers`` host processes), the counters merge
    once over the process group, and every rank ranks the same top-V.
    One process reduces to the local count."""
    local = count_terms_parallel(local_docs_tokens, num_workers)
    return build_vocab(merge_term_counts_multihost(local), vocab_size)


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
