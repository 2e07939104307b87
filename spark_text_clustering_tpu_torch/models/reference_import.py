"""Reader for Spark MLlib 2.4.3 ``DistributedLDAModel`` artifacts.

The reference saves its EM-trained models as three Parquet datasets and a
JSON metadata line (written at ``LDAClustering.scala:70``, read back at
``LDALoader.scala:37``):

  ``metadata/part-00000``     {class, version, k, vocabSize, docConcentration,
                               topicConcentration, iterationTimes, gammaShape}
  ``data/globalTopicTotals``  one row, the k-vector N_k
  ``data/topicCounts``        (id: long, topicWeights: k-vector) per graph
                              vertex; term ids are stored negative as
                              ``-(termIndex + 1)``, doc ids are >= 0
  ``data/tokenCounts``        (srcId: doc, dstId: negative term, tokenCounts:
                              double) per doc-term edge, the TF-IDF weights

The vocabulary is not in the model: it is a comma-joined one-line sidecar
at ``models/vocabularies/<model_name>`` (``LDAClustering.scala:71-72``).
An imported model is the port's :class:`~.base.LDAModel`, so scoring and
the report run on the reference's own trained parameters.

Vectors use Spark SQL's VectorUDT struct: ``{type: 0 sparse | 1 dense,
size, indices, values}``.  The Arrow columns are decoded as numpy arrays.
pyarrow is imported on first use only.
"""

from __future__ import annotations

import functools
import glob
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .base import LDAModel

__all__ = [
    "MLlibLDAArtifacts",
    "load_reference_model",
    "load_reference_vocab",
    "reference_doc_rows",
]


def _require_pyarrow():
    try:
        import pyarrow.parquet as pq

        return pq
    except ImportError as e:
        raise ImportError(
            "reading reference MLlib Parquet artifacts requires pyarrow"
        ) from e


def _read_parquet_dir(path: str):
    """Every ``part-*.parquet`` under ``path`` as one Arrow table (Spark
    writes a dataset as a directory of part files plus ``_SUCCESS``)."""
    pq = _require_pyarrow()
    import pyarrow as pa

    parts = sorted(glob.glob(os.path.join(path, "part-*.parquet")))
    if not parts:
        raise FileNotFoundError(f"no parquet part files under {path}")
    return pa.concat_tables([pq.read_table(p) for p in parts])


def _column(table, name: str):
    """One column of ``table`` as a single Arrow array."""
    return table.column(name).combine_chunks()


def _vectors_to_dense(col, size: int) -> np.ndarray:
    """[rows, size] float64 from a VectorUDT struct column: dense rows take
    their values, sparse rows scatter them at their indices."""
    n = len(col)
    fields = dict(zip((f.name for f in col.type), col.flatten()))
    kinds = fields["type"].to_numpy(zero_copy_only=False)
    vals = fields["values"]
    voff = vals.offsets.to_numpy()
    vflat = vals.values.to_numpy(zero_copy_only=False).astype(np.float64)
    lens = np.diff(voff)
    if n and (kinds == 1).all() and (lens == size).all():
        return vflat[voff[0]:voff[-1]].reshape(n, size).copy()
    idx = fields["indices"]
    ioff = idx.offsets.to_numpy()
    iflat = idx.values.to_numpy(zero_copy_only=False).astype(np.int64)
    out = np.zeros((n, size), np.float64)
    for r in range(n):
        row = vflat[voff[r]:voff[r + 1]]
        if kinds[r] == 1:
            out[r] = row
        else:
            out[r, iflat[ioff[r]:ioff[r + 1]]] = row
    return out


class MLlibLDAArtifacts:
    """The decoded artifacts of one saved DistributedLDAModel.  The
    doc-term edges are read on first use of ``edges``: scoring needs only
    the metadata and the vertices."""

    def __init__(self, path: str):
        self.path = path
        with open(
            os.path.join(path, "metadata", "part-00000"), encoding="utf-8"
        ) as f:
            self.metadata = json.loads(f.readline())
        k = int(self.metadata["k"])
        v = int(self.metadata["vocabSize"])
        self.k, self.vocab_size = k, v

        totals = _read_parquet_dir(
            os.path.join(path, "data", "globalTopicTotals"))
        name = ("topicCounts" if "topicCounts" in totals.column_names
                else totals.column_names[0])
        self.global_topic_totals = _vectors_to_dense(
            _column(totals, name), k)[0]

        # vertices: term rows -> beta counts [k, V]; doc rows -> gamma [k]
        tc = _read_parquet_dir(os.path.join(path, "data", "topicCounts"))
        vids = _column(tc, "id").to_numpy(zero_copy_only=False).astype(
            np.int64)
        vecs = _vectors_to_dense(_column(tc, "topicWeights"), k)
        self.beta = np.zeros((k, v), np.float64)
        terms = vids < 0
        self.beta[:, -(vids[terms] + 1)] = vecs[terms].T
        self.doc_gammas: Dict[int, np.ndarray] = {
            int(d): vecs[r] for r, d in zip(np.flatnonzero(~terms),
                                            vids[~terms])
        }

    @functools.cached_property
    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The doc-term edges in stored order as ``(doc int64, term
        int64, weight float64)`` arrays; the weights are the TF-IDF
        pseudo-counts."""
        ed = _read_parquet_dir(
            os.path.join(self.path, "data", "tokenCounts"))
        src = _column(ed, "srcId").to_numpy(zero_copy_only=False)
        dst = _column(ed, "dstId").to_numpy(zero_copy_only=False)
        w = _column(ed, "tokenCounts").to_numpy(zero_copy_only=False)
        doc = np.where(dst < 0, src, dst).astype(np.int64)
        term = -(np.where(dst < 0, dst, src).astype(np.int64) + 1)
        return doc, term, np.asarray(w, np.float64)


def load_reference_vocab(model_path: str) -> List[str]:
    """The comma-joined one-line vocabulary sidecar
    (``models/vocabularies/<model_name>``, LDAClustering.scala:71-72)."""
    base = os.path.dirname(model_path.rstrip("/"))
    name = os.path.basename(model_path.rstrip("/"))
    sidecar = os.path.join(base, "vocabularies", name)
    with open(sidecar, encoding="utf-8") as f:
        return f.read().strip("\n").split(",")


def load_reference_model(
    model_path: str,
    placeholder_vocab_ok: bool = True,
    device="cuda",
) -> LDAModel:
    """A frozen MLlib DistributedLDAModel as the port's ``LDAModel`` on
    ``device``.

    ``lam`` carries the EM topic-word counts (the matrix MLlib's
    ``toLocal`` hands to ``LocalLDAModel``), so ``topic_distribution``
    reproduces ``model.toLocal.topicDistribution`` (LDALoader.scala:108).
    Without a sidecar the vocabulary is ``term_<i>``, unless
    ``placeholder_vocab_ok`` is false: then a FileNotFoundError."""
    art = MLlibLDAArtifacts(model_path)
    try:
        vocab = load_reference_vocab(model_path)
    except FileNotFoundError:
        if not placeholder_vocab_ok:
            # scoring against fabricated term names would turn every
            # document into an empty row, without an error
            raise FileNotFoundError(
                f"vocabulary sidecar missing for {model_path} "
                "(expected ../vocabularies/<model_name> next to the "
                "model dir, LDAClustering.scala:71-72) — scoring "
                "needs the real term names"
            ) from None
        vocab = [f"term_{i}" for i in range(art.vocab_size)]
    meta = art.metadata
    alpha = np.asarray(meta["docConcentration"], np.float32)
    if alpha.ndim == 0:
        alpha = np.full((art.k,), float(alpha), np.float32)
    return LDAModel(
        lam=art.beta.astype(np.float32),
        vocab=vocab,
        alpha=alpha,
        eta=float(meta["topicConcentration"]),
        gamma_shape=float(meta.get("gammaShape", 100.0)),
        iteration_times=[float(t) for t in meta.get("iterationTimes", [])],
        algorithm="em",
        step=len(meta.get("iterationTimes", [])),
        device=device,
    )


def reference_doc_rows(
    art: MLlibLDAArtifacts,
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The training corpus rebuilt from the saved edges: ``[(doc_id,
    term_ids, tfidf_weights)]`` sorted by doc id, each doc's terms
    sorted."""
    doc, term, w = art.edges
    if not len(doc):
        return []
    order = np.lexsort((w, term, doc))
    doc, term, w = doc[order], term[order], w[order]
    starts = np.flatnonzero(np.r_[True, doc[1:] != doc[:-1]])
    ends = np.r_[starts[1:], len(doc)]
    return [
        (int(doc[s]), term[s:e].astype(np.int32), w[s:e].astype(np.float32))
        for s, e in zip(starts, ends)
    ]
