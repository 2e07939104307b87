"""Document frequency and IDF on the device (MLlib semantics):

    idf(t) = log((m + 1) / (df(t) + 1)),  0 when df(t) < min_doc_freq,

then the reference's patch: an idf of exactly 0 becomes ``idf_floor``
(0.0001) so low-df terms keep a tiny weight.
"""

from __future__ import annotations

import torch

from .sparse import DocTermBatch

__all__ = ["doc_freq", "idf_from_df", "idf_transform"]


def doc_freq(batch: DocTermBatch, vocab_size: int) -> torch.Tensor:
    """df[t] = number of docs containing term t.  Adds exact 1.0s, so the
    result is the same in any summation order."""
    present = (batch.token_weights > 0).to(torch.float32).reshape(-1)
    df = torch.zeros(vocab_size, dtype=torch.float32, device=present.device)
    return df.index_add_(0, batch.token_ids.reshape(-1).long(), present)


def idf_from_df(
    df: torch.Tensor, num_docs: int, min_doc_freq: int = 2
) -> torch.Tensor:
    """MLlib IDF(minDocFreq) fit: log((m+1)/(df+1)), 0 below the cutoff."""
    idf = torch.log((num_docs + 1.0) / (df + 1.0))
    return torch.where(df >= min_doc_freq, idf, torch.zeros_like(idf))


def idf_transform(
    batch: DocTermBatch, idf: torch.Tensor, idf_floor: float = 0.0001
) -> DocTermBatch:
    """tf * idf per active term, with the 0-idf -> ``idf_floor`` patch
    (``idf_floor=0`` disables it).  Padding (weight 0) stays 0."""
    per_token = idf[batch.token_ids.long()]
    if idf_floor:
        per_token = torch.where(
            per_token == 0.0, torch.full_like(per_token, idf_floor), per_token
        )
    return DocTermBatch(batch.token_ids, batch.token_weights * per_token)
