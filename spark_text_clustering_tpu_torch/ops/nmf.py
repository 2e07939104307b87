"""The W side of one NMF multiplicative-update sweep over corpus tiles.

The corpus is tiled once (``ops.packed.plan_corpus_tiles``): ``tt`` token
slots and ``d`` doc slots a tile, live tokens first and doc-contiguous,
pad tokens (``seg == d``, ``cts == 0``) at the end.  W lives in tile-slot
order, [n_tiles * d, k].  Per tile:

    xht   = sum over each slot's tokens of hg[:, t] * cts[t]    [d, k]
    w_new = w * xht / (w @ hht + eps)
    vals  = cts[t] * w_new[seg[t]]   (0 for pad tokens)          [tt, k]

``vals`` are the H update's scatter values in token order.
``nmf_mu_update_tiles`` launches the CUDA kernel (``csrc/nmf.cu``) for
tensors on the card and runs ``nmf_mu_update_tiles_plain``, the same
function in plain PyTorch, for tensors on the CPU.  On the card a tile is
one CTA of ``ops.packed.tile_warps(tt)`` warps, split as
``ops.packed.tile_work`` models it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .packed import tile_warps

__all__ = ["cost", "nmf_mu_update_tiles", "nmf_mu_update_tiles_plain"]

_EPS = 1e-9


def cost(hg_kt, cts, seg, w_slots, hht, d: int, eps: float = _EPS, *,
         live_tokens=None, live_slots=None) -> Tuple[int, float]:
    """(bytes, flops) of one launch on these inputs, shapes only: hg's k
    values, cts and seg of the live tokens and their k vals written, W
    read and written for the live slots, H H^T; k products and k scan
    adds a live token, the k x k denominator and the update a live slot.
    ``live_tokens`` / ``live_slots``: the plan's live counts (default:
    every token and slot, pads included)."""
    n_tiles, tt = cts.shape
    k = hg_kt.shape[0]
    tok = n_tiles * tt if live_tokens is None else int(live_tokens)
    slots = n_tiles * d if live_slots is None else int(live_slots)
    return (tok * (8 * k + 8) + slots * 8 * k + 4 * k * k,
            2.0 * k * tok + slots * (2.0 * k * k + 3 * k))


def nmf_mu_update_tiles_plain(
    hg_kt: torch.Tensor,     # [k, n_tiles * tt] H gathered at the token ids
    cts: torch.Tensor,       # [n_tiles, tt] token weights
    seg: torch.Tensor,       # [n_tiles, tt] tile-local doc slots (pad == d)
    w_slots: torch.Tensor,   # [n_tiles * d, k] tile-slot-ordered W
    hht: torch.Tensor,       # [k, k] H H^T
    d: int,
    eps: float = _EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch:
    ``(w_new [n_tiles * d, k], vals [n_tiles * tt, k])``."""
    n_tiles, tt = cts.shape
    k = hg_kt.shape[0]
    live = (seg < d).reshape(-1)
    wts = torch.where(live, cts.reshape(-1), 0.0)
    tile = torch.arange(n_tiles, device=seg.device)[:, None]
    slot = (tile * d + seg.long().clamp(max=d - 1)).reshape(-1)
    xht = torch.zeros((n_tiles * d, k), dtype=torch.float32,
                      device=w_slots.device).index_add_(0, slot,
                                                        (hg_kt * wts).T)
    w_new = w_slots * xht / (w_slots @ hht + eps)
    vals = torch.where(live[:, None], wts[:, None] * w_new[slot], 0.0)
    return w_new, vals


def nmf_mu_update_tiles(
    hg_kt: torch.Tensor,     # [k, n_tiles * tt] float32
    cts: torch.Tensor,       # [n_tiles, tt] float32
    seg: torch.Tensor,       # [n_tiles, tt] int32
    w_slots: torch.Tensor,   # [n_tiles * d, k] float32
    hht: torch.Tensor,       # [k, k] float32
    d: int,
    eps: float = _EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multiplicative W update over a tiled corpus:
    ``(w_new [n_tiles * d, k], vals [n_tiles * tt, k])``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if hg_kt.device.type == "cpu":
        return nmf_mu_update_tiles_plain(hg_kt, cts, seg, w_slots, hht, d, eps)
    n_tiles, tt = cts.shape
    k = hg_kt.shape[0]
    if k < 1 or d < 1 or hg_kt.shape != (k, n_tiles * tt) or (
        seg.shape != (n_tiles, tt) or w_slots.shape != (n_tiles * d, k)
        or hht.shape != (k, k)
    ):
        raise ValueError(
            f"shapes hg{tuple(hg_kt.shape)} cts{tuple(cts.shape)} "
            f"seg{tuple(seg.shape)} w{tuple(w_slots.shape)} "
            f"hht{tuple(hht.shape)} do not agree with d={d}"
        )
    if seg.dtype != torch.int32 or any(
        t.dtype != torch.float32 for t in (hg_kt, cts, w_slots, hht)
    ):
        raise TypeError("nmf_mu_update_tiles takes float32 hg/cts/w/hht and "
                        "int32 seg")
    _build.check_tensors("nmf_mu_update_tiles", hg_kt, cts, seg, w_slots, hht)
    lib = _build.load_library("nmf")
    warps = tile_warps(tt)
    if lib.stc_nmf_smem_bytes(k, d, tt, warps) <= 0:
        raise ValueError(f"the NMF kernel's indices overflow at k={k}, d={d}, "
                         f"tt={tt}")
    w_new = torch.empty((n_tiles * d, k), dtype=torch.float32,
                        device=hg_kt.device)
    vals = torch.empty((n_tiles * tt, k), dtype=torch.float32,
                       device=hg_kt.device)
    if n_tiles == 0:
        return w_new, vals
    # where the piece table does not fit shared memory it lives here
    per_tile = lib.stc_nmf_scratch_floats(k, d, tt, warps)
    scratch = (torch.empty(n_tiles * per_tile, dtype=torch.float32,
                           device=hg_kt.device) if per_tile else None)
    err = lib.stc_nmf_mu_update_tiles(
        hg_kt.data_ptr(), cts.data_ptr(), seg.data_ptr(), w_slots.data_ptr(),
        hht.data_ptr(), n_tiles, k, tt, d, warps, eps, w_new.data_ptr(),
        vals.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(hg_kt.device).cuda_stream,
    )
    _build.check(err, "nmf_mu_update_tiles")
    _build.count_launch(
        "nmf_mu_update_tiles",
        lambda: cost(hg_kt, cts, seg, w_slots, hht, d, eps),
        0 if scratch is None else _build.nbytes(scratch))
    return w_new, vals
