"""Sparse document-term batches as torch tensors.

A batch is a padded COO-by-row block: ``token_ids [B, L]`` int32 vocab ids
of each doc's distinct terms and ``token_weights [B, L]`` float32 counts
(or TF-IDF weights).  Padding is id 0 with weight 0, so pad slots add
exactly nothing anywhere.  Corpora are bucketed by next-power-of-two row
length to bound the padding when doc lengths span orders of magnitude.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "DocTermBatch",
    "batch_from_rows",
    "bucket_by_length",
    "bucket_indices_by_length",
    "next_pow2",
    "pad_rows",
]


@dataclass
class DocTermBatch:
    """A batch of sparse documents with shape [B, L]."""

    token_ids: torch.Tensor      # int32 [B, L]
    token_weights: torch.Tensor  # float32 [B, L]

    @property
    def num_docs(self) -> int:
        return int(self.token_ids.shape[0])


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


_EMPTY_ROW = (np.zeros(0, np.int32), np.zeros(0, np.float32))


def pad_rows(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]], capacity: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``rows`` padded to ``capacity`` docs with empty rows (weight-0 docs
    add nothing anywhere): the pinned batch axis of a streaming trigger."""
    if len(rows) > capacity:
        raise ValueError(f"{len(rows)} rows > capacity {capacity}")
    return list(rows) + [_EMPTY_ROW] * (capacity - len(rows))


def batch_from_rows(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    row_len: int | None = None,
    min_row_len: int = 8,
    device="cpu",
) -> DocTermBatch:
    """Pack host (ids, weights) rows into one padded batch on ``device``;
    ``row_len`` defaults to next_pow2(max nnz)."""
    max_nnz = max((len(i) for i, _ in rows), default=0)
    L = row_len if row_len is not None else max(min_row_len, next_pow2(max_nnz))
    if max_nnz > L:
        raise ValueError(f"row_len={L} < max nnz {max_nnz}")
    ids = np.zeros((len(rows), L), np.int32)
    wts = np.zeros((len(rows), L), np.float32)
    for r, (i, w) in enumerate(rows):
        ids[r, : len(i)] = i
        wts[r, : len(w)] = w
    return DocTermBatch(
        torch.from_numpy(ids).to(device), torch.from_numpy(wts).to(device)
    )


def bucket_indices_by_length(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    min_row_len: int = 8,
) -> Dict[int, List[int]]:
    """{bucket_len: original_row_indices} — the power-of-two bucketing
    rule shared by scoring and the IDF fit."""
    buckets: Dict[int, List[int]] = {}
    for idx, (ids, _) in enumerate(rows):
        buckets.setdefault(max(min_row_len, next_pow2(len(ids))), []).append(idx)
    return buckets


def bucket_by_length(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    min_row_len: int = 8,
    device="cpu",
) -> Dict[int, Tuple[DocTermBatch, List[int]]]:
    """{bucket_len: (batch, original_row_indices)}, sorted by length."""
    out: Dict[int, Tuple[DocTermBatch, List[int]]] = {}
    for L, idxs in sorted(bucket_indices_by_length(rows, min_row_len).items()):
        out[L] = (
            batch_from_rows([rows[i] for i in idxs], row_len=L, device=device),
            idxs,
        )
    return out
