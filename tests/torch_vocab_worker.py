"""What each rank of the CPU grid of ``test_torch_library_args.py`` runs
(not a test file).  The ranks are spawned processes: this module imports
the port only, never jax."""

from __future__ import annotations

from spark_text_clustering_tpu_torch.pipeline import CountVectorizer


def vocab_rank(grid, docs, vocab_size):
    """The vocabulary this rank derives from its own documents (every
    ``data_shards``-th, from its rank) with ``docs_are_process_local``."""
    ranks = grid.data_shards * grid.model_shards
    local = docs[grid.rank::ranks]
    cv = CountVectorizer(vocab_size=vocab_size, num_workers=1,
                         docs_are_process_local=True)
    return cv.fit({"tokens": local}).vocab, len(local)
