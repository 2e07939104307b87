"""The vocab-sorted token layout of the packed EM sweep, and the scatter of
token posteriors into the term-topic table.

``plan_em_scatter`` is host numpy: it sorts each (data shard, model
shard) pair's live tokens by vocab tile of ``vt`` columns and packs them
into ``tb``-token blocks, one consecutive run of blocks per tile.  The
fit reorders its token arrays into this layout once, so every sweep's
posteriors come out already in kernel order.

``scatter_add_vtiles`` is ``zeros[k, shard_v].at[:, ids].add(wphi.T)``
over posteriors in plan order: the CUDA kernel (``csrc/emscatter.cu``)
for tensors on the card, ``scatter_add_vtiles_plain`` for CPU tensors.
The kernel gives each piece of a token block (``scatter_piece`` slots,
a divisor of ``tb``) its own thread block, so a tile of many blocks
spreads over many SMs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "EmScatterPlan",
    "cost",
    "plan_em_scatter",
    "scatter_add_vtiles",
    "scatter_add_vtiles_plain",
    "scatter_piece",
]

# 256-column vocab tiles x 1024-token blocks: the JAX package's geometry,
# kept so the two packages lay the corpus out identically.
_VT = 256
_TB = 1024
# topics one thread block of the scatter kernel stages and reduces; wider
# k splits across grid.y
_KC = 32
# slots one thread block of the scatter kernel takes at most (32 lanes x
# 16 slots; csrc/emscatter.cu kMaxPiece)
_PIECE = 512


class EmScatterPlan(NamedTuple):
    """Static vocab-sorted token layout for one packed corpus.

    ``sort_order`` maps each slot of the sorted-padded token axis to an
    index into the original per-data-shard token axis (``t_local`` for
    pad slots).  ``lids`` is each slot's column within its vocab tile
    (pad slots -1); ``block_vtile`` maps each block to its vocab tile and
    ``block_first`` marks a tile's first block (kept so the plan equals
    the JAX package's; the CUDA kernels find a tile's blocks by binary
    search on ``block_vtile``).  Every tile owns >= 1 block; pad blocks at
    the end continue the last tile."""

    sort_order: np.ndarray   # [S_d, S_m * nb * tb] int64
    lids: np.ndarray         # [S_d, S_m, nb, 1, tb] int32
    block_vtile: np.ndarray  # [S_d, S_m, nb] int32
    block_first: np.ndarray  # [S_d, S_m, nb] int32 (0/1)
    n_vtiles: int
    nb: int
    vt: int
    tb: int


def plan_em_scatter(
    ids: np.ndarray,     # [S_d, T_local] int32 global vocab ids
    cts: np.ndarray,     # [S_d, T_local] float32 (0 => pad slot)
    n_model: int,
    shard_v: int,
    vt: int = _VT,
    tb: int = _TB,
) -> Optional[EmScatterPlan]:
    """Sort each (data shard, model shard) pair's live tokens by vocab tile
    and pack them into ``tb``-token blocks, one run per tile.  Returns None
    for degenerate geometry (zero-width shards)."""
    if shard_v <= 0 or ids.size == 0:
        return None
    s_d, t_local = ids.shape
    n_vtiles = (shard_v + vt - 1) // vt

    pair_data = []
    nb_uniform = 0
    for s in range(s_d):
        live = np.nonzero(cts[s] > 0)[0]
        gids = ids[s][live]
        for m in range(n_model):
            sel = (gids >= m * shard_v) & (gids < (m + 1) * shard_v)
            tok_idx = live[sel].astype(np.int64)
            lid = (gids[sel] - m * shard_v).astype(np.int64)
            order = np.argsort(lid, kind="stable")
            tok_idx, lid = tok_idx[order], lid[order]
            cnt = np.bincount(lid // vt, minlength=n_vtiles)
            nb_v = np.maximum(-(-cnt // tb), 1)
            pair_data.append((s, m, tok_idx, lid, cnt, nb_v))
            nb_uniform = max(nb_uniform, int(nb_v.sum()))

    sort_order = np.full((s_d, n_model, nb_uniform * tb), t_local, np.int64)
    lids = np.full((s_d, n_model, nb_uniform, tb), -1, np.int32)
    block_vtile = np.full((s_d, n_model, nb_uniform), n_vtiles - 1, np.int32)
    block_first = np.zeros((s_d, n_model, nb_uniform), np.int32)
    for s, m, tok_idx, lid, cnt, nb_v in pair_data:
        starts_v = np.zeros(n_vtiles, np.int64)
        np.cumsum(nb_v[:-1], out=starts_v[1:])
        block_vtile[s, m, : int(nb_v.sum())] = np.repeat(
            np.arange(n_vtiles, dtype=np.int32), nb_v
        )
        block_first[s, m, starts_v] = 1
        if tok_idx.size:
            first_tok = np.zeros(n_vtiles + 1, np.int64)
            np.cumsum(cnt, out=first_tok[1:])
            vtile = lid // vt
            slot = (
                starts_v[vtile] * tb
                + np.arange(tok_idx.size, dtype=np.int64)
                - first_tok[vtile]
            )
            sort_order[s, m, slot] = tok_idx
            lids[s, m].reshape(-1)[slot] = lid % vt
    return EmScatterPlan(
        sort_order.reshape(s_d, n_model * nb_uniform * tb),
        lids.reshape(s_d, n_model, nb_uniform, 1, tb),
        block_vtile,
        block_first,
        n_vtiles,
        nb_uniform,
        vt,
        tb,
    )


@lru_cache(maxsize=None)
def scatter_piece(tb: int) -> int:
    """Slots each thread block of the scatter kernel takes: the largest
    divisor of ``tb`` that is at most 512, so no piece spans two blocks
    (and so two vocab tiles)."""
    return max(p for p in range(1, min(tb, _PIECE) + 1) if tb % p == 0)


def cost(
    wphi_sorted, lids, block_vtile, *, shard_v: int,
    live: Optional[int] = None, **geometry,
) -> Tuple[int, float]:
    """(bytes, flops) of one launch on these inputs, shapes only: the k
    posteriors of ``live`` slots (default: every slot, pads included; the
    kernel skips pad slots), every slot's lid, the block map, and the
    [k, shard_v] table written once; k adds a live slot."""
    k = wphi_sorted.shape[1]
    live = wphi_sorted.shape[0] if live is None else int(live)
    return (4 * k * live + _build.nbytes(lids, block_vtile)
            + 4 * k * shard_v, float(k * live))


def scatter_add_vtiles_plain(
    wphi_sorted: torch.Tensor,  # [nb * tb, k]
    lids: torch.Tensor,         # [nb, 1, tb] int32
    block_vtile: torch.Tensor,  # [nb] int32
    *,
    n_vtiles: int,
    vt: int,
    tb: int,
    shard_v: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: column = tile * vt + lid."""
    k = wphi_sorted.shape[1]
    flat = lids.reshape(-1).long()
    cols = block_vtile.long().repeat_interleave(tb) * vt + flat
    live = flat >= 0
    out = wphi_sorted.new_zeros(k, n_vtiles * vt)
    out.index_add_(1, cols[live], wphi_sorted[live].T)
    return out[:, :shard_v]


def scatter_add_vtiles(
    wphi_sorted: torch.Tensor,  # [nb * tb, k] posteriors, kernel order
    lids: torch.Tensor,         # [nb, 1, tb] int32
    block_vtile: torch.Tensor,  # [nb] int32
    *,
    n_vtiles: int,
    nb: int,
    vt: int,
    tb: int,
    shard_v: int,
    live: Optional[int] = None,
) -> torch.Tensor:
    """``zeros[k, shard_v].at[:, ids].add(wphi.T)`` for tokens in plan
    order.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.  ``live``, the plan's live slots where the caller
    holds them on the host, only feeds ``cost``."""
    if wphi_sorted.device.type == "cpu":
        return scatter_add_vtiles_plain(
            wphi_sorted, lids, block_vtile,
            n_vtiles=n_vtiles, vt=vt, tb=tb, shard_v=shard_v,
        )
    k = wphi_sorted.shape[1]
    if wphi_sorted.shape != (nb * tb, k) or lids.shape != (nb, 1, tb) or (
        block_vtile.shape != (nb,)
    ):
        raise ValueError("scatter_add_vtiles: shapes do not match the plan")
    if wphi_sorted.dtype != torch.float32 or lids.dtype != torch.int32 or (
        block_vtile.dtype != torch.int32
    ):
        raise TypeError("scatter_add_vtiles takes f32 posteriors and i32 maps")
    _build.check_tensors("scatter_add_vtiles", wphi_sorted, lids, block_vtile)
    if vt > 1024:
        raise ValueError("scatter_add_vtiles: vt must be <= 1024")
    dev = wphi_sorted.device
    piece = scatter_piece(tb)
    n_pieces = nb * (tb // piece)
    # columns no token hits stay 0; the kernel writes every other column
    out = torch.zeros((k, shard_v), dtype=torch.float32, device=dev)
    meta = torch.empty((n_pieces, 4), dtype=torch.int32, device=dev)
    part = torch.empty((n_pieces, 2, k), dtype=torch.float32, device=dev)
    err = _build.load_library("emscatter").stc_scatter_add_vtiles(
        wphi_sorted.data_ptr(), lids.data_ptr(), block_vtile.data_ptr(),
        nb, tb, piece, k, min(k, _KC), vt, shard_v, out.data_ptr(),
        meta.data_ptr(), part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "scatter_add_vtiles")
    _build.count_launch(
        "scatter_add_vtiles",
        lambda: cost(wphi_sorted, lids, block_vtile, shard_v=shard_v,
                     live=live),
        _build.nbytes(meta, part))
    return out
