"""Gamma fixed point of the LDA E-step over token-packed corpus tiles.

The corpus is packed once, in doc order, into tiles of ``tt`` token slots
and ``d`` doc slots with no document straddling a tile
(``plan_corpus_tiles``; numpy, the JAX package's planner copied so the
plan, and with it which docs are sampled together, is the same on every
device).  The host-streaming online fit plans each chunk of minibatches
with one shared geometry instead (``plan_tile_pack_uniform``).  A tile's live tokens come first, doc-contiguous with ``seg``
nondecreasing; pad tokens (``seg == d``, ``cts == 0``) sit at its end; its
live doc slots are ``0..n_live-1`` and pad slots follow.

``gamma_fixed_point_tiles`` launches the CUDA kernel (``csrc/packed.cu``)
for tensors on the card and runs ``gamma_fixed_point_tiles_plain``, the
same function in plain PyTorch, for tensors on the CPU.  Per tile:

    gamma <- alpha + exp(E[log theta]) * sum over the slot's tokens of
             eb * cts / phinorm,   phinorm = eb . exp(E[log theta]) + 1e-30

until the tile's worst mean|delta gamma| over its d slots drops below
``tol`` (or at ``max_inner``), with the inline ``digamma_approx``.

On the card a tile is one CTA of ``tile_warps(tt)`` warps; ``tile_work``
is how the kernel splits a tile among them (its live tokens in equal
warp ranges, its live slots round robin).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .estep import _prep_alpha, digamma_approx

__all__ = [
    "cost",
    "TilePlan",
    "UniformTilePlan",
    "plan_tile_pack",
    "plan_tile_pack_uniform",
    "plan_corpus_tiles",
    "gamma_fixed_point_tiles",
    "gamma_fixed_point_tiles_plain",
    "tile_gamma_to_docs",
    "docs_gamma_to_tiles",
    "TileWork",
    "tile_warps",
    "tile_work",
]

_PHI_EPS = 1e-30
# warps of the tile kernel's CTA, at most (csrc/packed.cu kMaxWarps)
_TILE_MAX_WARPS = 16

# The JAX package's tile budget and doc-slot floor (its VMEM budget and
# Mosaic's 128-lane gamma block), kept so both packages cut the corpus
# into the same tiles.  The CUDA kernel's own shared-memory gate lives in
# csrc/packed.cu.
_VMEM_TILE_BUDGET = 6 * 1024 * 1024
_MIN_TILE_DOCS = 128


class TilePlan(NamedTuple):
    """Tile-aligned repack of a flat doc-contiguous token stream.

    ``ids/cts/seg`` are [n_tiles, tt]; ``seg`` holds tile-local doc slots
    in [0, d) with pad slots at exactly ``d``.  ``doc_ids`` is
    [n_tiles, d] mapping local slots to positions in the caller's doc
    order, with ``b`` (one past the last real doc) marking pad slots.
    """

    ids: np.ndarray      # [n_tiles, tt] int32
    cts: np.ndarray      # [n_tiles, tt] float32
    seg: np.ndarray      # [n_tiles, tt] int32 (== d for pad slots)
    doc_ids: np.ndarray  # [n_tiles, d] int32 (== b for pad slots)
    tt: int
    d: int
    b: int


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def plan_tile_pack(
    ids: np.ndarray,
    cts: np.ndarray,
    seg: np.ndarray,
    b: int,
    tile_tokens: Optional[int] = None,
    max_docs: Optional[int] = None,
    k: int = 0,
    min_tile_docs: int = _MIN_TILE_DOCS,
) -> Optional[TilePlan]:
    """Greedy first-fit of a doc-contiguous token stream (``seg``
    nondecreasing) into [tt-token x d-doc] tiles, no doc straddling a
    tile.  Docs with zero tokens still get a slot; input tokens with
    ``cts == 0`` are dropped.  None when one doc is wider than the tile
    or the tile exceeds the budget."""
    ids = np.asarray(ids)
    cts = np.asarray(cts)
    seg = np.asarray(seg)
    counts = np.bincount(seg[cts > 0], minlength=b).astype(np.int64)
    max_nnz = int(counts.max()) if b else 0

    tt = tile_tokens or max(512, _pow2(max_nnz))
    if max_nnz > tt:
        return None
    # tile i takes the longest doc run whose token sum stays within tt
    cum = np.zeros(b + 1, np.int64)
    np.cumsum(counts, out=cum[1:])

    def fences(doc_cap: Optional[int]) -> np.ndarray:
        out = [0]
        i = 0
        while i < b:
            j = int(np.searchsorted(cum, cum[i] + tt, side="right")) - 1
            j = max(j, i + 1)
            if doc_cap is not None:
                j = min(j, i + doc_cap)
            out.append(j)
            i = j
        return np.asarray(out, np.int64)

    fence = fences(None)
    n_tiles = max(1, len(fence) - 1)
    d = _pow2(int(np.diff(fence).max()) if len(fence) > 1 else 1)
    d = max(d, min_tile_docs)
    if max_docs is not None and d > max_docs:
        fence = fences(max_docs)
        n_tiles = max(1, len(fence) - 1)
        d = max(
            min_tile_docs,
            _pow2(int(np.diff(fence).max()) if len(fence) > 1 else 1),
        )
    if (d + 2 + 2 * k) * tt * 4 > _VMEM_TILE_BUDGET:
        return None

    out_ids = np.zeros((n_tiles, tt), np.int32)
    out_cts = np.zeros((n_tiles, tt), np.float32)
    out_seg = np.full((n_tiles, tt), d, np.int32)
    out_doc = np.full((n_tiles, d), b, np.int32)

    # each tile's live tokens are one contiguous slice of the live
    # stream and its doc slots one arange: three flat scatters
    live = cts > 0
    ids_l, cts_l, seg_l = ids[live], cts[live], seg[live]
    tok_fence = np.searchsorted(seg_l, np.arange(b + 1), side="left")
    if len(fence) > 1 and ids_l.size:
        tile_tok0 = tok_fence[fence]
        tok_counts = np.diff(tile_tok0)
        tok_tile = np.repeat(
            np.arange(len(tok_counts), dtype=np.int64), tok_counts
        )
        pos = np.arange(ids_l.size, dtype=np.int64) - np.repeat(
            tile_tok0[:-1], tok_counts
        )
        flat = tok_tile * tt + pos
        out_ids.reshape(-1)[flat] = ids_l
        out_cts.reshape(-1)[flat] = cts_l
        out_seg.reshape(-1)[flat] = seg_l - np.repeat(fence[:-1], tok_counts)
    if len(fence) > 1 and b:
        doc_counts = np.diff(fence)
        doc_tile = np.repeat(
            np.arange(len(doc_counts), dtype=np.int64), doc_counts
        )
        doc_pos = np.arange(b, dtype=np.int64) - np.repeat(
            fence[:-1], doc_counts
        )
        out_doc.reshape(-1)[doc_tile * d + doc_pos] = np.arange(b)
    return TilePlan(out_ids, out_cts, out_seg, out_doc, tt, d, b)


class UniformTilePlan(NamedTuple):
    """``m`` minibatch tile plans sharing one geometry (tt, d, n_tiles).
    Arrays are [m, n_tiles, tt] / [m, n_tiles, d]; the tiles past a
    batch's own count are all pad (``seg == d``, ``doc_ids == b``) and
    contribute nothing."""

    ids: np.ndarray      # [m, n_tiles, tt] int32
    cts: np.ndarray      # [m, n_tiles, tt] float32
    seg: np.ndarray      # [m, n_tiles, tt] int32 (== d for pad slots)
    doc_ids: np.ndarray  # [m, n_tiles, d] int32 (== b for pad slots)
    tt: int
    d: int
    n_tiles: int
    b: int


def plan_tile_pack_uniform(
    batches,
    b: int,
    tile_tokens: Optional[int] = None,
    n_tiles_multiple: int = 1,
    k: int = 0,
) -> Optional[UniformTilePlan]:
    """Plan a chunk of packed minibatches, each (ids, cts, seg) over the
    same ``b`` doc positions, with one geometry: ``tt`` from the chunk's
    widest doc (or ``tile_tokens``), ``d`` from its fullest tile, and
    ``n_tiles`` from its largest batch rounded up to a power of two and
    then to ``n_tiles_multiple``.  The JAX package's planner, budget and
    rounding included, so both packages cut a minibatch into the same
    tiles.  None when no geometry fits the budget."""
    batches = list(batches)
    if not batches:
        return None
    max_nnz = 0
    for _, cts, seg in batches:
        cts_a, seg_a = np.asarray(cts), np.asarray(seg)
        if cts_a.size:
            counts = np.bincount(seg_a[cts_a > 0].astype(np.int64),
                                 minlength=b)
            if counts.size:
                max_nnz = max(max_nnz, int(counts.max()))
    tt = tile_tokens or max(512, _pow2(max_nnz))
    if max_nnz > tt:
        return None
    cap = _VMEM_TILE_BUDGET // (4 * tt) - 2 - 2 * k
    if cap < _MIN_TILE_DOCS:
        return None
    cap = 1 << (cap.bit_length() - 1)  # pow2 floor: pow2-up(d) <= cap

    plans = []
    for ids, cts, seg in batches:
        p = plan_tile_pack(ids, cts, seg, b, tile_tokens=tt, max_docs=cap,
                           k=k)
        if p is None:
            return None
        plans.append(p)
    d = max(p.d for p in plans)
    n_tiles = _pow2(max(p.ids.shape[0] for p in plans))
    n_tiles = -(-n_tiles // n_tiles_multiple) * n_tiles_multiple
    if (d + 2 + 2 * k) * tt * 4 > _VMEM_TILE_BUDGET:
        return None

    m = len(plans)
    out_ids = np.zeros((m, n_tiles, tt), np.int32)
    out_cts = np.zeros((m, n_tiles, tt), np.float32)
    out_seg = np.full((m, n_tiles, tt), d, np.int32)
    out_doc = np.full((m, n_tiles, d), b, np.int32)
    for j, p in enumerate(plans):
        nt = p.ids.shape[0]
        out_ids[j, :nt] = p.ids
        out_cts[j, :nt] = p.cts
        s = p.seg.copy()
        s[s == p.d] = d  # the pad sentinel at the shared d
        out_seg[j, :nt] = s
        out_doc[j, :nt, : p.doc_ids.shape[1]] = p.doc_ids
    return UniformTilePlan(out_ids, out_cts, out_seg, out_doc,
                           tt, d, n_tiles, b)


def plan_corpus_tiles(
    flat_ids: np.ndarray,
    flat_cts: np.ndarray,
    offsets: np.ndarray,      # [n+1] doc token fences into the flat arrays
    *,
    tile_tokens: Optional[int] = None,
    n_shards: int = 1,
    k: int = 0,
    min_tile_docs: int = _MIN_TILE_DOCS,
) -> Optional[TilePlan]:
    """Tile the whole corpus once, in doc order: ``doc_ids`` carry global
    doc ids (pad slots == n).  The tile axis is padded with all-pad tiles
    at the end to a multiple of ``n_shards``.  None when no geometry fits
    the budget."""
    n = len(offsets) - 1
    doc_lens = np.diff(offsets)
    seg = np.repeat(np.arange(n, dtype=np.int64), doc_lens).astype(np.int32)
    max_nnz = int(doc_lens.max()) if n else 0
    tt = tile_tokens or max(512, _pow2(max_nnz))
    if max_nnz > tt:
        return None
    cap = _VMEM_TILE_BUDGET // (4 * tt) - 2 - 2 * k
    if cap < min_tile_docs:
        return None
    cap = 1 << (cap.bit_length() - 1)
    p = plan_tile_pack(
        flat_ids, flat_cts, seg, n, tile_tokens=tt, max_docs=cap, k=k,
        min_tile_docs=min_tile_docs,
    )
    if p is None:
        return None
    n_tiles = p.ids.shape[0]
    pad_to = ((n_tiles + n_shards - 1) // n_shards) * n_shards
    if pad_to != n_tiles:
        extra = pad_to - n_tiles
        p = TilePlan(
            np.concatenate([p.ids, np.zeros((extra, p.tt), np.int32)]),
            np.concatenate([p.cts, np.zeros((extra, p.tt), np.float32)]),
            np.concatenate([p.seg, np.full((extra, p.tt), p.d, np.int32)]),
            np.concatenate([p.doc_ids, np.full((extra, p.d), n, np.int32)]),
            p.tt, p.d, n,
        )
    return p


class TileWork(NamedTuple):
    """How the tile kernel splits one tile among its warps."""

    n_tok: int           # live tokens (a prefix of the tile)
    n_act: int           # live doc slots, 0..n_act-1
    tokens_per_warp: int  # R: warp w takes live tokens [w R, (w+1) R)
    pieces: np.ndarray   # [n_pieces, 4] (warp, slot, t0, t1) in token order


def tile_warps(tt: int) -> int:
    """Warps of the tile kernel's CTA: one per 32 token slots, 1..16."""
    return max(1, min(_TILE_MAX_WARPS, -(-int(tt) // 32)))


def tile_work(seg_row: np.ndarray, d: int, warps: int) -> TileWork:
    """The kernel's split of one tile (``seg_row`` [tt], pad == d): the
    live tokens in ranges of R (a multiple of 32 that covers them with
    ``warps`` warps), a piece per doc run inside a range, whose k sums the
    kernel writes to row slot + warp of its piece table; live slot s is
    updated by warp s % warps."""
    seg_row = np.asarray(seg_row)
    pad = np.flatnonzero(seg_row >= d)
    n_tok = int(pad[0]) if pad.size else len(seg_row)
    n_act = int(seg_row[n_tok - 1]) + 1 if n_tok else 0
    per = -(-n_tok // warps)
    r = 32 if per <= 32 else -(-per // 32) * 32
    start = np.searchsorted(seg_row[:n_tok], np.arange(n_act + 1))
    pieces = []
    for s in range(n_act):
        t, end = int(start[s]), int(start[s + 1])
        while t < end:
            w = t // r
            t1 = min(end, (w + 1) * r)
            pieces.append((w, s, t, t1))
            t = t1
    return TileWork(n_tok, n_act, r,
                    np.asarray(pieces, np.int64).reshape(-1, 4))


def cost(eb_kt, cts, seg, alpha, gamma0, d: int, max_inner: int = 100,
         tol: float = 1e-3, *, iters=None, live_tokens=None,
         live_slots=None):
    """(bytes, flops) of one launch on these inputs, shapes only: eb, seg
    and cts of the live tokens, gamma0 read and gamma written for the live
    slots, alpha; 4k + 1 flops a live token a tile iteration (phinorm,
    the ratio, the k products and adds of the slot sums).
    ``live_tokens``: each tile's live tokens [n_tiles] (default: all tt,
    pads included); ``live_slots``: the live doc slots (default: every
    slot); ``iters``: each tile's iterations (default: one)."""
    n_tiles, tt = cts.shape
    k = eb_kt.shape[0]
    tok = _build.host_counts(live_tokens, n_tiles, tt)
    its = _build.host_counts(iters, n_tiles, 1)
    slots = n_tiles * d if live_slots is None else int(live_slots)
    return (int(tok.sum()) * (4 * k + 8) + 8 * k * slots + 4 * k,
            float((its * tok).sum()) * (4 * k + 1))


def gamma_fixed_point_tiles_plain(
    eb_kt: torch.Tensor,     # [k, n_tiles * tt] gathered exp(E[log beta])
    cts: torch.Tensor,       # [n_tiles, tt]
    seg: torch.Tensor,       # [n_tiles, tt] tile-local doc slots (pad == d)
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [k, n_tiles * d] tile-slot-ordered inits
    d: int,
    max_inner: int = 100,
    tol: float = 1e-3,
    with_iters: bool = False,
):
    """The kernel's function in plain PyTorch.  All tiles iterate
    together; a tile stops updating the iteration its worst slot
    converges.  With ``with_iters``, also returns the iterations each
    tile ran [n_tiles]."""
    n_tiles, tt = cts.shape
    k = eb_kt.shape[0]
    alpha = _prep_alpha(alpha, k, eb_kt.device)[:, None, None]
    eb = eb_kt.reshape(k, n_tiles, tt)
    # a pad token reads slot d-1; its cts == 0 makes it add exactly 0
    slot = seg.clamp(max=d - 1).long().expand(k, n_tiles, tt)
    gamma = gamma0.reshape(k, n_tiles, d).clone()
    active = torch.ones(n_tiles, dtype=torch.bool, device=eb.device)
    iters = torch.zeros(n_tiles, dtype=torch.int64, device=eb.device)
    for _ in range(max_inner):
        et = torch.exp(digamma_approx(gamma) - digamma_approx(
            gamma.sum(dim=0, keepdim=True)))                  # [k, nt, d]
        phinorm = (eb * torch.gather(et, 2, slot)).sum(dim=0) + _PHI_EPS
        contrib = torch.zeros_like(gamma).scatter_add_(
            2, slot, eb * (cts / phinorm))
        g_new = alpha + et * contrib
        worst = (g_new - gamma).abs().mean(dim=0).amax(dim=1)  # [n_tiles]
        gamma = torch.where(active[None, :, None], g_new, gamma)
        iters += active
        active = active & (worst >= tol)
        if not bool(active.any()):
            break
    gamma = gamma.reshape(k, n_tiles * d)
    return (gamma, iters) if with_iters else gamma


def gamma_fixed_point_tiles(
    eb_kt: torch.Tensor,     # [k, n_tiles * tt]
    cts: torch.Tensor,       # [n_tiles, tt]
    seg: torch.Tensor,       # [n_tiles, tt] int32
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [k, n_tiles * d]
    d: int,
    max_inner: int = 100,
    tol: float = 1e-3,
) -> torch.Tensor:
    """Converged gamma [k, n_tiles * d] in tile-slot order
    (``tile_gamma_to_docs`` puts it back in doc order).  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if eb_kt.device.type == "cpu":
        return gamma_fixed_point_tiles_plain(
            eb_kt, cts, seg, alpha, gamma0, d, max_inner, tol
        )
    n_tiles, tt = cts.shape
    k = eb_kt.shape[0]
    alpha = _prep_alpha(alpha, k, eb_kt.device)
    if eb_kt.shape != (k, n_tiles * tt) or seg.shape != (n_tiles, tt) or (
        gamma0.shape != (k, n_tiles * d)
    ):
        raise ValueError(
            f"shapes eb{tuple(eb_kt.shape)} cts{tuple(cts.shape)} "
            f"seg{tuple(seg.shape)} gamma0{tuple(gamma0.shape)} do not "
            f"agree with d={d}"
        )
    if eb_kt.dtype != torch.float32 or cts.dtype != torch.float32 or (
        gamma0.dtype != torch.float32
    ) or seg.dtype != torch.int32:
        raise TypeError("gamma_fixed_point_tiles takes float32 eb/cts/gamma0 "
                        "and int32 seg")
    _build.check_tensors("gamma_fixed_point_tiles", eb_kt, cts, seg, alpha,
                         gamma0)
    lib = _build.load_library("packed")
    warps = tile_warps(tt)
    if lib.stc_tiles_smem_bytes(k, d, tt, warps) <= 0:
        raise ValueError(f"the tile kernel refuses k={k}, d={d}, tt={tt}")
    out = torch.empty((k, n_tiles * d), dtype=torch.float32,
                      device=eb_kt.device)
    if n_tiles == 0:
        return out
    # where the tile state does not fit shared memory it lives here
    per_tile = lib.stc_tiles_scratch_floats(k, d, tt, warps)
    scratch = (torch.empty(n_tiles * per_tile, dtype=torch.float32,
                           device=eb_kt.device) if per_tile else None)
    err = lib.stc_gamma_fixed_point_tiles(
        eb_kt.data_ptr(), cts.data_ptr(), seg.data_ptr(), alpha.data_ptr(),
        gamma0.data_ptr(), n_tiles, k, tt, d, max_inner, warps, tol,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(eb_kt.device).cuda_stream,
    )
    _build.check(err, "gamma_fixed_point_tiles")
    _build.count_launch(
        "gamma_fixed_point_tiles",
        lambda: cost(eb_kt, cts, seg, alpha, gamma0, d, max_inner, tol),
        0 if scratch is None else _build.nbytes(scratch))
    return out


def tile_gamma_to_docs(
    gamma_tiles: torch.Tensor,  # [k, n_tiles * d]
    doc_ids: torch.Tensor,      # [n_tiles, d] (== b for pad slots)
    b: int,
) -> torch.Tensor:
    """Tile-slot gammas back to [b, k] doc order (pad slots land on a
    discarded overflow row; docs in no slot stay at ones)."""
    k = gamma_tiles.shape[0]
    out = torch.ones((b + 1, k), dtype=torch.float32,
                     device=gamma_tiles.device)
    out[doc_ids.reshape(-1).long()] = gamma_tiles.T
    return out[:b]


def docs_gamma_to_tiles(
    gamma0: torch.Tensor,       # [b, k] doc-ordered inits
    doc_ids: torch.Tensor,      # [n_tiles, d]
) -> torch.Tensor:
    """Doc-ordered gamma inits -> [k, n_tiles * d] tile-slot order (pad
    slots read an all-ones overflow row)."""
    k = gamma0.shape[1]
    padded = torch.cat([gamma0, gamma0.new_ones((1, k))])
    return padded[doc_ids.reshape(-1).long()].T.contiguous()
