"""Writer for Spark MLlib 2.4.3 ``DistributedLDAModel`` artifacts.

``save_reference_model`` writes the layout the reference's ``ldaModel.save``
writes (``LDAClustering.scala:70``, and the vocabulary sidecar at
``:71-72``), which ``reference_import.load_reference_model`` (and Spark's
``DistributedLDAModel.load``) reads:

  ``metadata/part-00000``     one JSON line {class, version "1.0", k,
                              vocabSize, docConcentration,
                              topicConcentration, iterationTimes,
                              gammaShape}, in Spark's key order
  ``data/globalTopicTotals``  one row, the k-dim dense VectorUDT N_k
  ``data/topicCounts``        (id: long, topicWeights: VectorUDT): term
                              vertices with id = -(termIndex + 1); doc
                              vertices (id >= 0) when doc topic counts are
                              given
  ``data/tokenCounts``        (srcId: doc, dstId: negative term,
                              tokenCounts: double) per doc-term edge
  ``../vocabularies/<name>``  the comma-joined one-line vocabulary

Each dataset dir gets Spark's ``_SUCCESS`` marker, and every Parquet file
carries the ``org.apache.spark.sql.parquet.row.metadata`` schema metadata
of the reference's own part files, so Spark SQL rebuilds the VectorUDT
columns.  Values are written as float64: float32 parameters round-trip
bitwise.  The columns are built from numpy arrays; the tables equal the
JAX package's, which builds them from Python rows.  The part names carry a UUID derived from the dataset name, so
an export is byte-stable across runs.  pyarrow is imported on first use
only.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .base import LDAModel

__all__ = ["save_reference_model"]

# org.apache.spark.sql.parquet.row.metadata values, verbatim from the
# reference's own saved part files: Spark SQL needs them to decode the
# VectorUDT struct columns.
_VECTOR_UDT_SQL = {
    "type": "udt",
    "class": "org.apache.spark.mllib.linalg.VectorUDT",
    "pyClass": "pyspark.mllib.linalg.VectorUDT",
    "sqlType": {
        "type": "struct",
        "fields": [
            {"name": "type", "type": "byte", "nullable": False,
             "metadata": {}},
            {"name": "size", "type": "integer", "nullable": True,
             "metadata": {}},
            {"name": "indices",
             "type": {"type": "array", "elementType": "integer",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
            {"name": "values",
             "type": {"type": "array", "elementType": "double",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
        ],
    },
}

_ROW_METADATA = {
    "globalTopicTotals": {
        "type": "struct",
        "fields": [
            {"name": "globalTopicTotals", "type": _VECTOR_UDT_SQL,
             "nullable": True, "metadata": {}},
        ],
    },
    "topicCounts": {
        "type": "struct",
        "fields": [
            {"name": "id", "type": "long", "nullable": False,
             "metadata": {}},
            {"name": "topicWeights", "type": _VECTOR_UDT_SQL,
             "nullable": True, "metadata": {}},
        ],
    },
    "tokenCounts": {
        "type": "struct",
        "fields": [
            {"name": "srcId", "type": "long", "nullable": False,
             "metadata": {}},
            {"name": "dstId", "type": "long", "nullable": False,
             "metadata": {}},
            {"name": "tokenCounts", "type": "double", "nullable": False,
             "metadata": {}},
        ],
    },
}


def _pa():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401

        return pyarrow
    except ImportError as e:
        raise ImportError(
            "writing MLlib Parquet artifacts requires pyarrow"
        ) from e


def _vector_type(pa):
    """Spark VectorUDT physical struct (1 = dense; sparse unused here)."""
    return pa.struct([
        pa.field("type", pa.int8(), nullable=False),
        pa.field("size", pa.int32()),
        pa.field("indices", pa.list_(
            pa.field("element", pa.int32(), nullable=False))),
        pa.field("values", pa.list_(
            pa.field("element", pa.float64(), nullable=False))),
    ])


def _dense_vectors(pa, rows: np.ndarray):
    """A VectorUDT column of dense vectors, one a row of ``rows`` [n, k]
    (float64): type 1, size and indices null."""
    vec_t = _vector_type(pa)
    n, k = rows.shape
    values = pa.ListArray.from_arrays(
        pa.array(np.arange(n + 1, dtype=np.int32) * k),
        pa.array(np.ascontiguousarray(rows, np.float64).reshape(-1)),
        type=vec_t.field("values").type,
    )
    return pa.StructArray.from_arrays(
        [pa.array(np.ones(n, np.int8)), pa.nulls(n, pa.int32()),
         pa.nulls(n, vec_t.field("indices").type), values],
        fields=list(vec_t),
    )


def _job_uuid(dataset: str) -> str:
    """Spark part files carry the write job's random UUID
    (``part-00000-<uuid>-c000.snappy.parquet``).  Ours is derived from
    the dataset name, as the JAX package's is, so exports stay
    byte-stable across runs and match Spark's naming shape."""
    import hashlib

    h = hashlib.sha1(dataset.encode()).hexdigest()
    return (
        f"{h[0:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"
    )


def _write_dataset(path: str, table, dataset: str) -> None:
    """One Spark-style dataset dir: part file + ``_SUCCESS`` marker."""
    _pa()
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    schema = table.schema.with_metadata({
        b"org.apache.spark.sql.parquet.row.metadata": json.dumps(
            _ROW_METADATA[dataset], separators=(",", ":")
        ).encode(),
    })
    table = table.cast(schema)
    pq.write_table(
        table,
        os.path.join(
            path,
            f"part-00000-{_job_uuid(dataset)}-c000.snappy.parquet",
        ),
        compression="snappy",
    )
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass


def save_reference_model(
    model: LDAModel,
    path: str,
    *,
    doc_topic_counts: Optional[np.ndarray] = None,
    doc_rows: Optional[
        Sequence[Tuple[np.ndarray, np.ndarray]]
    ] = None,
) -> None:
    """Write ``model`` in the MLlib ``DistributedLDAModel`` layout at
    ``path`` (conventionally ``<models_dir>/LdaModel_<lang>_<millis>``).

    ``lam`` provides the term vertices and the global topic totals (row
    sums).  ``doc_topic_counts`` [D, k] (EM's N_dk) adds the doc vertices
    and ``doc_rows`` the doc-term edges — pass both for a full graph dump
    Spark can re-run ``logLikelihood`` on; without them the export still
    round-trips through ``load_reference_model`` (which reads topics,
    metadata, and hyperparameters).

    The vocabulary sidecar goes to ``<models_dir>/vocabularies/<name>``
    exactly like ``LDAClustering.scala:71-72``.
    """
    pa = _pa()
    lam = np.asarray(model.lam, np.float64)
    k, v = lam.shape

    # ---- metadata/part-00000 (JSON line + _SUCCESS) --------------------
    meta_dir = os.path.join(path, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    alpha = np.broadcast_to(np.asarray(model.alpha, np.float64), (k,))
    meta = {
        "class": "org.apache.spark.mllib.clustering.DistributedLDAModel",
        "version": "1.0",
        "k": k,
        "vocabSize": v,
        "docConcentration": [float(a) for a in alpha],
        "topicConcentration": float(model.eta),
        "iterationTimes": [float(t) for t in model.iteration_times],
        "gammaShape": float(model.gamma_shape),
    }
    with open(
        os.path.join(meta_dir, "part-00000"), "w", encoding="utf-8"
    ) as f:
        f.write(json.dumps(meta, separators=(",", ":")) + "\n")
    with open(os.path.join(meta_dir, "_SUCCESS"), "w"):
        pass

    # ---- data/globalTopicTotals ---------------------------------------
    totals = lam.sum(axis=1)
    _write_dataset(
        os.path.join(path, "data", "globalTopicTotals"),
        pa.Table.from_arrays(
            [_dense_vectors(pa, totals[None])],
            names=["globalTopicTotals"],
        ),
        "globalTopicTotals",
    )

    # ---- data/topicCounts: term vertices (+ optional doc vertices) ----
    ids = -(np.arange(v, dtype=np.int64) + 1)
    vecs = lam.T
    if doc_topic_counts is not None:
        dtc = np.asarray(doc_topic_counts, np.float64)
        ids = np.concatenate([ids, np.arange(dtc.shape[0], dtype=np.int64)])
        vecs = np.concatenate([vecs, dtc])
    _write_dataset(
        os.path.join(path, "data", "topicCounts"),
        pa.Table.from_arrays(
            [pa.array(ids, type=pa.int64()), _dense_vectors(pa, vecs)],
            names=["id", "topicWeights"],
        ),
        "topicCounts",
    )

    # ---- data/tokenCounts: doc-term edges -----------------------------
    rows = list(doc_rows) if doc_rows is not None else []
    lens = [len(t_ids) for t_ids, _ in rows]
    srcs = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    dsts = -(np.concatenate(
        [np.asarray(t_ids, np.int64) for t_ids, _ in rows]
        or [np.zeros(0, np.int64)]) + 1)
    wts = np.concatenate(
        [np.asarray(t_wts, np.float64) for _, t_wts in rows]
        or [np.zeros(0, np.float64)])
    _write_dataset(
        os.path.join(path, "data", "tokenCounts"),
        pa.Table.from_arrays(
            [
                pa.array(srcs, type=pa.int64()),
                pa.array(dsts, type=pa.int64()),
                pa.array(wts, type=pa.float64()),
            ],
            names=["srcId", "dstId", "tokenCounts"],
        ),
        "tokenCounts",
    )

    # ---- vocabulary sidecar (LDAClustering.scala:71-72) ---------------
    base = os.path.dirname(path.rstrip("/"))
    name = os.path.basename(path.rstrip("/"))
    voc_dir = os.path.join(base, "vocabularies")
    os.makedirs(voc_dir, exist_ok=True)
    with open(os.path.join(voc_dir, name), "w", encoding="utf-8") as f:
        f.write(",".join(model.vocab))
