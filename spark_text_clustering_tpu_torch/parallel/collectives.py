"""Collectives over a ``ProcessGrid``: the reductions behind the JAX
package's sharded train steps, with the same names.

  Spark pattern                           here
  -------------------------------------------------------------
  treeAggregate (suff. stats over docs)   ``psum_data``
  shuffle reduceByKey (term counts)       scatter-add, then ``psum_data``
  collect to driver                       ``fetch_global``

Only ``all_reduce`` (and ``broadcast``, in ``mesh``) are used: they are
the two collectives that gloo runs on CUDA tensors as well as on CPU
ones.  A gather is an ``all_reduce`` of a zero-filled buffer into which
each rank writes what it owns.  Every function is called by every rank of
the groups it reduces over, in the same order; on an axis of one rank it
reduces nothing.  Reductions happen in place on freshly computed partials
and return them.

Every call counts in ``collective.<name>.calls`` and its operands' bytes
in ``collective.<name>.traced_bytes``, under the JAX package's op names.
JAX counts each collective once when it traces a program; the port's
collectives run eagerly, so its counters are true per-call totals of this
rank.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..telemetry.dispatch import note_collective
from ..ops.sparse import DocTermBatch, batch_from_rows
from .mesh import DATA_AXIS, MODEL_AXIS, ProcessGrid

_EMPTY = (np.zeros(0, np.int32), np.zeros(0, np.float32))
# the (name, operand bytes) of the collectives called inside
# count_collectives(), else None
_audit_calls: Optional[List[Tuple[str, int]]] = None

__all__ = [
    "count_collectives",
    "data_shard_rows",
    "fetch_global",
    "gather_model_rows",
    "gather_model_rows_bkl",
    "gather_model_rows_kbl",
    "model_handoff",
    "model_row_sum",
    "note_host_handoff",
    "psum_data",
    "psum_model",
    "scatter_add_model_shard",
    "scatter_add_model_shard_bkl",
]


@contextlib.contextmanager
def count_collectives():
    """Collect ``(name, operand bytes)`` of each collective called inside
    the block, whether telemetry is on or off: the trace audits' hook
    (lint layer 2's STC205 reads the names, layer 3's STC214 the bytes).
    Yields the list it fills."""
    global _audit_calls
    outer, _audit_calls = _audit_calls, []
    try:
        yield _audit_calls
    finally:
        _audit_calls = outer


def _acct(name: str, *tensors) -> None:
    """One call of the collective ``name`` and its operands' bytes."""
    if _audit_calls is None and not telemetry.enabled():
        return
    nbytes = sum(int(t.numel()) * t.element_size() for t in tensors)
    if _audit_calls is not None:
        _audit_calls.append((name, nbytes))
    if not telemetry.enabled():
        return
    telemetry.count(f"collective.{name}.calls")
    telemetry.count(f"collective.{name}.traced_bytes", nbytes)
    # the call in flight owns the bytes (dispatch.<digest>.collective_bytes)
    note_collective(nbytes)


def _all_reduce(grid: ProcessGrid, x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    if not x.is_contiguous():
        x = x.contiguous()
    if grid.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    dist.all_reduce(x, group=group)
    if grid.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        grid.stats["seconds"] += time.perf_counter() - t0
        grid.stats["calls"] += 1
        grid.stats["bytes"] += x.numel() * x.element_size()
    return x


def psum_data(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Sum over the document shards (the ranks of this rank's column)."""
    _acct("psum_data", x)
    return _all_reduce(grid, x, grid.data_group)


def psum_model(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Sum over the vocabulary shards (the ranks of this rank's row)."""
    _acct("psum_model", x)
    return _all_reduce(grid, x, grid.model_group)


def model_row_sum(grid: ProcessGrid, table_shard: torch.Tensor
                  ) -> torch.Tensor:
    """Row sums [k] of a vocabulary-sharded [k, V] table: this shard's
    sums, then ``psum_model``."""
    return psum_model(grid, table_shard.sum(dim=-1))


def _local_ids(grid: ProcessGrid, ids: torch.Tensor, shard_v: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global vocabulary ids as this shard's columns, and which it owns."""
    local = ids.long() - grid.m * shard_v
    return local, (local >= 0) & (local < shard_v)


def gather_model_rows(grid: ProcessGrid, table_shard: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """``full_table[:, ids]`` as [..., k] without the full [k, V] table:
    each vocabulary shard gathers the ids it owns, zeros the rest, and one
    ``psum_model`` combines them (one shard owns each id)."""
    _acct("gather_model_rows", ids)
    shard_v = table_shard.shape[-1]
    local, own = _local_ids(grid, ids, shard_v)
    vals = table_shard.T[local.clamp(0, shard_v - 1)]          # [..., k]
    vals = torch.where(own[..., None], vals, vals.new_zeros(()))
    return psum_model(grid, vals)


def gather_model_rows_kbl(grid: ProcessGrid, table_shard: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """``gather_model_rows`` in the [k, ...] layout, the token axis last:
    ``full_table[:, ids]`` as the tile kernels take it."""
    _acct("gather_model_rows_kbl", ids)
    shard_v = table_shard.shape[-1]
    local, own = _local_ids(grid, ids, shard_v)
    vals = table_shard[:, local.clamp(0, shard_v - 1)]         # [k, ...]
    vals = torch.where(own[None], vals, vals.new_zeros(()))
    return psum_model(grid, vals.contiguous())


def gather_model_rows_bkl(grid: ProcessGrid, table_shard: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """``gather_model_rows`` for ids [B, L] in the [B, k, L] layout of the
    padded E-step kernel."""
    _acct("gather_model_rows_bkl", ids)
    shard_v = table_shard.shape[-1]
    local, own = _local_ids(grid, ids, shard_v)
    vals = table_shard[:, local.clamp(0, shard_v - 1)]         # [k, B, L]
    vals = vals.permute(1, 0, 2)                               # [B, k, L]
    vals = torch.where(own[:, None, :], vals, vals.new_zeros(()))
    return psum_model(grid, vals.contiguous())


def scatter_add_model_shard(grid: ProcessGrid, ids: torch.Tensor,
                            vals: torch.Tensor, shard_v: int
                            ) -> torch.Tensor:
    """Add token values [..., k] into this rank's vocabulary shard [k,
    shard_v]: tokens other shards own go to an overflow column and are
    dropped.  The partial still needs ``psum_data``."""
    _acct("scatter_add_model_shard", vals)
    k = vals.shape[-1]
    local, own = _local_ids(grid, ids, shard_v)
    cols = torch.where(own, local, torch.full_like(local, shard_v))
    out = vals.new_zeros(k, shard_v + 1)
    out.index_add_(1, cols.reshape(-1), vals.reshape(-1, k).T)
    return out[:, :shard_v].contiguous()


def scatter_add_model_shard_bkl(grid: ProcessGrid, ids: torch.Tensor,
                                vals: torch.Tensor, shard_v: int
                                ) -> torch.Tensor:
    """``scatter_add_model_shard`` for ids [B, L] and values in the [B, k,
    L] layout."""
    _acct("scatter_add_model_shard_bkl", vals)
    return scatter_add_model_shard(grid, ids, vals.permute(0, 2, 1),
                                   shard_v)


def fetch_global(grid: ProcessGrid, local: torch.Tensor, axis: str
                 ) -> np.ndarray:
    """The whole of a sharded tensor on the host of every rank (Spark's
    collect to driver): ``axis="model"`` joins vocabulary shards along the
    last dimension, ``axis="data"`` document shards along the first.
    Each rank writes its part of a zero-filled buffer; one ``all_reduce``
    over that axis's group fills it in."""
    _acct("fetch_global", local)
    if axis == MODEL_AXIS:
        n, group, idx = grid.model_shards, grid.model_group, grid.m
        full = local.new_zeros(*local.shape[:-1], n * local.shape[-1])
        w = local.shape[-1]
        full[..., idx * w:(idx + 1) * w] = local
    elif axis == DATA_AXIS:
        n, group, idx = grid.data_shards, grid.data_group, grid.d
        full = local.new_zeros(n * local.shape[0], *local.shape[1:])
        w = local.shape[0]
        full[idx * w:(idx + 1) * w] = local
    else:
        raise ValueError(f"unknown axis {axis!r}")
    return _all_reduce(grid, full, group).cpu().numpy()


def model_handoff(grid: ProcessGrid, n_wk_shard: torch.Tensor, v: int
                  ) -> np.ndarray:
    """Fit -> model handoff: the full [k, V_pad] table on every rank's
    host, cut to the ``v`` real columns."""
    return fetch_global(grid, n_wk_shard, MODEL_AXIS)[:, :v]


def note_host_handoff(nbytes: int) -> None:
    """A 1x1 fit's [k, V] table handed over to the model: the JAX
    package's handoff pair, ``handoff.deferred_bytes`` (JAX keeps the
    table on the device until the model's first host-side use) and
    ``handoff.downloads`` (that use's one download).  The port downloads
    at the handoff, where a CLI run of the JAX package pays it when it
    saves the model."""
    telemetry.gauge("handoff.deferred_bytes", nbytes)
    telemetry.count("handoff.downloads")


def data_shard_rows(grid: ProcessGrid, rows: Sequence, row_len: int,
                    device) -> Tuple[DocTermBatch, int, int]:
    """This rank's block of ``rows`` (JAX's ``data_shard_batch``): the rows
    padded with empty ones to a multiple of the data shards, cut into
    equal consecutive blocks, block ``d`` as a [per, row_len] batch on
    ``device``.  Returns (batch, lo, hi): rows ``[lo, hi)`` are real, the
    rest of the block is empty pads."""
    n = len(rows)
    per = max(1, -(-n // grid.data_shards))
    lo = min(n, grid.d * per)
    hi = min(n, lo + per)
    block = list(rows[lo:hi]) + [_EMPTY] * (per - (hi - lo))
    batch = batch_from_rows(block, row_len=row_len, device=device)
    # the host -> device staging of this rank's block
    _acct("h2d_batch", batch.token_ids, batch.token_weights)
    return batch, lo, hi
