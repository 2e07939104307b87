"""What each rank of a CPU grid runs for ``test_torch_sharding.py`` (not a
test file).  The ranks are spawned processes: this module imports torch,
numpy and the port only, never jax.

``suite(grid, spec)`` runs every check of one grid shape in one spawn and
returns its results as numpy arrays and floats; the test file holds them
against the JAX package and against full-table references.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spark_text_clustering_tpu_torch import EMLDA, IDF, Params
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.models import sharded_eval
from spark_text_clustering_tpu_torch.models.base import LDAModel
from spark_text_clustering_tpu_torch.ops.sparse import batch_from_rows
from spark_text_clustering_tpu_torch.ops.tfidf import make_doc_freq_sharded
from spark_text_clustering_tpu_torch.parallel import (
    data_shard_rows,
    fetch_global,
    gather_model_rows,
    gather_model_rows_bkl,
    gather_model_rows_kbl,
    model_handoff,
    model_row_sum,
    psum_data,
    psum_model,
    scatter_add_model_shard,
    scatter_add_model_shard_bkl,
)


def _shard(grid, full: np.ndarray) -> torch.Tensor:
    """This rank's vocabulary columns of a [k, V_pad] table."""
    w = full.shape[1] // grid.model_shards
    return torch.from_numpy(
        np.ascontiguousarray(full[:, grid.m * w:(grid.m + 1) * w]))


def collectives(grid, spec) -> dict:
    """Every collective on the inputs of ``spec["coll"]``."""
    c = spec["coll"]
    table = _shard(grid, c["table"])
    shard_v = table.shape[1]
    ids = torch.from_numpy(c["ids"])                       # [B, L]
    vals = torch.from_numpy(c["vals"])                     # [B, L, k]
    ones = torch.ones(3)
    out = {
        "psum_data": psum_data(grid, ones.clone()).numpy(),
        "psum_model": psum_model(grid, ones.clone()).numpy(),
        "row_sum": model_row_sum(grid, table).numpy(),
        "gather": gather_model_rows(grid, table, ids).numpy(),
        "gather_bkl": gather_model_rows_bkl(grid, table, ids).numpy(),
        "gather_kbl": gather_model_rows_kbl(grid, table, ids).numpy(),
        "scatter": fetch_global(grid, psum_data(
            grid, scatter_add_model_shard(grid, ids, vals, shard_v)),
            "model"),
        "scatter_bkl": fetch_global(grid, psum_data(
            grid, scatter_add_model_shard_bkl(
                grid, ids, vals.permute(0, 2, 1).contiguous(), shard_v)),
            "model"),
        "fetch_model": fetch_global(grid, table, "model"),
        "handoff": model_handoff(grid, table, c["v"]),
    }
    rows = spec["rows_fused"]
    block, lo, hi = data_shard_rows(grid, rows, 64, "cpu")
    out["block"] = (lo, hi, block.token_ids.shape[0],
                    int((block.token_weights.sum(1) > 0).sum()))
    out["fetch_data"] = fetch_global(grid, block.token_weights, "data")
    return out


def em_fit(grid, rows, v, params, iters=None) -> tuple:
    opt = EMLDA(params, device="cpu", grid=grid)
    model = opt.fit(rows, [f"t{i}" for i in range(v)],
                    max_iterations=iters)
    return (model.lam, opt.last_log_likelihood / len(rows), opt.last_sweep,
            model.step)


def suite(grid, spec) -> dict:
    """Every check of one grid shape (see the test file)."""
    torch.set_num_threads(1)
    out = {"rank": grid.rank, "coords": (grid.d, grid.m), "pid": os.getpid()}
    out["coll"] = collectives(grid, spec)

    rows, v = spec["rows_fused"], spec["v"]
    df_fn = make_doc_freq_sharded(grid, v)
    block, _, _ = data_shard_rows(grid, rows, 64, "cpu")
    out["df"] = df_fn(block).numpy()
    ds = {"rows": rows, "vocab": [f"t{i}" for i in range(v)]}
    out["idf"] = IDF(device="cpu", grid=grid).fit(ds).idf

    fits = {}
    for name, (rows_f, layout) in spec["fits"].items():
        params = Params(k=spec["k"], max_iterations=spec["iters"],
                        token_layout=layout,
                        checkpoint_dir=spec["ckpt"][name],
                        checkpoint_interval=100)
        fits[name] = em_fit(grid, rows_f, v, params)
    out["fits"] = fits

    if grid.size == 4:
        out.update(suite_2x2(grid, spec))
    return out


def suite_2x2(grid, spec) -> dict:
    """The checks of the 2x2 grid only: fits from a seed, checkpoints
    written on the grid, and sharded evaluation."""
    out = {}
    k, v = spec["k"], spec["v"]
    for layout in ("packed", "padded"):
        params = Params(k=k, max_iterations=spec["iters"], seed=5,
                        token_layout=layout)
        out[f"seed_{layout}"] = em_fit(grid, spec["rows_fused"], v, params)

    # em_state.npz written at 2x2, for 1x1 resumes in both packages; the
    # odd-V corpus's checkpoint is resumed again here, on the grid
    for name, (rows_c, v_c) in spec["ckpt_rows"].items():
        params = Params(k=k, max_iterations=4, seed=3, token_layout="packed",
                        checkpoint_dir=spec["ckpt_out"][name],
                        checkpoint_interval=2)
        out[f"ckpt_{name}"] = em_fit(grid, rows_c, v_c, params)
        # interval 100: the resume to step 6 writes no checkpoint
        out[f"ckpt_{name}_resumed"] = em_fit(
            grid, rows_c, v_c, params.replace(checkpoint_interval=100),
            iters=6)

    e = spec["eval"]
    online = lda_model_from_numpy(e["lam"], e["alpha"], e["eta"],
                                  [f"t{i}" for i in range(e["lam"].shape[1])],
                                  algorithm="online", device="cpu")
    em = lda_model_from_numpy(e["n_wk"], e["em_alpha"], e["em_eta"],
                              [f"t{i}" for i in range(e["n_wk"].shape[1])],
                              algorithm="em", device="cpu")
    rows_e = e["rows"]
    out["dist"] = online.topic_distribution(rows_e, grid=grid)
    out["bound"] = online.log_likelihood(rows_e, grid=grid)
    out["perplexity"] = online.log_perplexity(rows_e, grid=grid)
    out["em_bound"] = em.log_likelihood(rows_e, grid=grid)
    batch = batch_from_rows(rows_e)
    fn = sharded_eval.make_sharded_em_log_likelihood(
        grid, alpha=e["em_alpha"], eta=e["em_eta"],
        vocab_size=e["n_wk"].shape[1])
    blk, lo, hi = data_shard_rows(grid, rows_e, batch.token_ids.shape[1],
                                  "cpu")
    n_dk = torch.zeros(blk.token_ids.shape[0], k)
    n_dk[:hi - lo] = torch.from_numpy(e["n_dk"][lo:hi])
    out["em_loglik"] = float(fn(em._lam_on_grid(grid), n_dk, blk.token_ids,
                                blk.token_weights))
    top = sharded_eval.make_sharded_top_terms(grid, e["lam"].shape[1], 6)
    out["top_terms"] = top(online._lam_on_grid(grid))
    LDAModel._DEVICE_TOPK_MIN_V = 0
    out["describe"] = online.describe_topics(6, grid=grid)
    try:
        online.topic_distribution(rows_e, grid=grid, convergence="per_doc")
    except ValueError as exc:
        out["per_doc_error"] = str(exc)
    return out
