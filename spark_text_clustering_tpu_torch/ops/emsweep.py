"""One fused EM sweep over the packed corpus.

Per live token of the plan layout (``emscatter.plan_em_scatter``):

    term = N_wk[:, tile * vt + lid] + eta - 1
    doc  = (N_dk + alpha - 1)[seg]
    phi  = term * doc * inv_denom, normalized over k;  wphi = cts * phi

and the sweep returns N_wk' [k, shard_v] and N_dk' [d_pad, k].  Pad slots
(lid == -1, cts == 0) add exactly 0.  ``em_sweep_fused`` launches the CUDA
kernel (``csrc/emsweep.cu``) for tensors on the card and runs
``em_sweep_fused_plain`` for CPU tensors.

The kernel reads the tokens twice: in the plan's vocab-sorted layout for
N_wk', and doc-contiguous (the doc stream: ``doc_cols``, ``doc_cts``,
``doc_seg``, docs in nondecreasing order) for N_dk'.  The EM fit passes
its packed arrays as the doc stream; ``doc_stream`` builds one from the
sorted layout.  The plain version computes both outputs from the sorted
layout and ignores the doc stream.

``fused_eligible`` is the one fused-vs-two-stage predicate: the doc axis
must be at most ``MAX_FUSED_DOC_SLOTS``, the JAX package's bound, on
every device, so both packages take the same branch on the same corpus.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .emscatter import scatter_piece

__all__ = [
    "MAX_FUSED_DOC_SLOTS",
    "cost",
    "doc_stream",
    "em_sweep_fused",
    "em_sweep_fused_plain",
    "fused_d_pad",
    "fused_eligible",
]

MAX_FUSED_DOC_SLOTS = 512
# doc-stream slots one thread block of the kernel takes (csrc/emsweep.cu
# kMaxPiece)
_DOC_PIECE = 512


def fused_d_pad(d_max: int) -> int:
    """Doc-slot axis padded to a multiple of 8."""
    return max(8, -(-d_max // 8) * 8)


def fused_eligible(d_max: int) -> bool:
    """True when the fused sweep takes a corpus of ``d_max`` doc slots
    (else two-stage), on every device and at every k."""
    return d_max <= MAX_FUSED_DOC_SLOTS


def doc_stream(
    lids: torch.Tensor,         # [nb, 1, tb] int32 (pad -1)
    seg: torch.Tensor,          # [nb, 1, tb] int32
    cts: torch.Tensor,          # [nb, 1, tb] f32
    block_vtile: torch.Tensor,  # [nb] int32
    vt: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The live slots of the sorted layout, stable-sorted by doc: (global
    columns int32, weights f32, doc slots int32), each [live]."""
    lid = lids.reshape(-1).long()
    live = (lid >= 0).nonzero().squeeze(1)
    cols = (block_vtile.long().repeat_interleave(lids.shape[-1]) * vt
            + lid)[live]
    s = seg.reshape(-1)[live]
    order = torch.sort(s, stable=True).indices
    return (cols[order].to(torch.int32).contiguous(),
            cts.reshape(-1)[live][order].contiguous(),
            s[order].to(torch.int32).contiguous())


def cost(
    nwk_shard, docf_kd, inv_denom, lids, seg, cts, block_vtile,
    doc_cols=None, doc_cts=None, doc_seg=None, *, d_pad: int, shard_v: int,
    live: Optional[int] = None, **geometry,
) -> Tuple[int, float]:
    """(bytes, flops) of one launch on these inputs, shapes only: the
    table, the doc factor, inv_denom, every slot's lid and the block map
    read once, seg and cts of ``live`` slots (default: every slot, pads
    included), and the two outputs written once (the doc stream's second
    read of the tokens lies above it); 8k flops a live slot."""
    k = nwk_shard.shape[0]
    live = cts.numel() if live is None else int(live)
    return (_build.nbytes(nwk_shard, docf_kd, inv_denom, lids, block_vtile)
            + 8 * live + 4 * k * (shard_v + d_pad), 8.0 * k * live)


def em_sweep_fused_plain(
    nwk_shard: torch.Tensor,    # [k, shard_v]
    docf_kd: torch.Tensor,      # [k, d_pad] (N_dk + alpha - 1)^T, padded
    inv_denom: torch.Tensor,    # [k]
    lids: torch.Tensor,         # [nb, 1, tb] int32 (pad -1)
    seg: torch.Tensor,          # [nb, 1, tb] int32
    cts: torch.Tensor,          # [nb, 1, tb] f32 (pad 0)
    block_vtile: torch.Tensor,  # [nb] int32
    doc_cols: torch.Tensor,     # unused: the sorted layout holds the tokens
    doc_cts: torch.Tensor,
    doc_seg: torch.Tensor,
    *,
    n_vtiles: int,
    nb: int,
    vt: int,
    tb: int,
    d_pad: int,
    shard_v: int,
    eta_m1: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (gathers and index adds)."""
    k = nwk_shard.shape[0]
    lid = lids.reshape(-1).long()
    live = lid >= 0
    cols = block_vtile.long().repeat_interleave(tb) * vt + lid.clamp(min=0)
    cols = cols.clamp(max=shard_v - 1)
    s = seg.reshape(-1).long()
    c = cts.reshape(-1)
    term = nwk_shard[:, cols].T + eta_m1                     # [T, k]
    doc = docf_kd[:, s].T                                    # [T, k]
    phi = term * doc * inv_denom
    phi = phi / (phi.sum(dim=-1, keepdim=True) + 1e-30)
    wphi = (c[:, None] * phi)[live]
    nwk_new = nwk_shard.new_zeros(k, n_vtiles * vt)
    nwk_new.index_add_(1, (block_vtile.long().repeat_interleave(tb) * vt
                           + lid)[live], wphi.T)
    ndk = nwk_shard.new_zeros(d_pad, k)
    ndk.index_add_(0, s[live], wphi)
    return nwk_new[:, :shard_v], ndk


def em_sweep_fused(
    nwk_shard: torch.Tensor,    # [k, shard_v] this model shard's table
    docf_kd: torch.Tensor,      # [k, d_pad] (N_dk + alpha - 1)^T, padded
    inv_denom: torch.Tensor,    # [k] 1 / (N_k + eta*V - V)
    lids: torch.Tensor,         # [nb, 1, tb] int32 (pad slots == -1)
    seg: torch.Tensor,          # [nb, 1, tb] int32 doc slots
    cts: torch.Tensor,          # [nb, 1, tb] f32 weights (pad 0)
    block_vtile: torch.Tensor,  # [nb] int32
    doc_cols: torch.Tensor,     # [n] int32 global columns, doc-contiguous
    doc_cts: torch.Tensor,      # [n] f32 weights
    doc_seg: torch.Tensor,      # [n] int32 doc slots, nondecreasing
    *,
    n_vtiles: int,
    nb: int,
    vt: int,
    tb: int,
    d_pad: int,
    shard_v: int,
    eta_m1: float,
    live: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM sweep: (N_wk' [k, shard_v], N_dk' [d_pad, k]).  The doc
    stream must hold the sorted layout's live tokens (tokens of weight 0
    may be added: they add 0).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  ``live``, the plan's live slots
    where the caller holds them on the host, only feeds ``cost``."""
    if nwk_shard.device.type == "cpu":
        return em_sweep_fused_plain(
            nwk_shard, docf_kd, inv_denom, lids, seg, cts, block_vtile,
            doc_cols, doc_cts, doc_seg, n_vtiles=n_vtiles, nb=nb, vt=vt,
            tb=tb, d_pad=d_pad, shard_v=shard_v, eta_m1=eta_m1)
    k = nwk_shard.shape[0]
    n_doc = doc_cols.shape[0]
    plan_shape = (nb, 1, tb)
    f32, i32 = torch.float32, torch.int32
    for t, shape, dtype in (
        (nwk_shard, (k, shard_v), f32), (docf_kd, (k, d_pad), f32),
        (inv_denom, (k,), f32), (lids, plan_shape, i32),
        (seg, plan_shape, i32), (cts, plan_shape, f32),
        (block_vtile, (nb,), i32), (doc_cols, (n_doc,), i32),
        (doc_cts, (n_doc,), f32), (doc_seg, (n_doc,), i32),
    ):
        if t.shape != shape:
            raise ValueError("em_sweep_fused: shapes do not match the plan")
        if t.dtype != dtype:
            raise TypeError("em_sweep_fused takes f32 counts and i32 maps")
    _build.check_tensors("em_sweep_fused", nwk_shard, docf_kd, inv_denom,
                         lids, seg, cts, block_vtile, doc_cols, doc_cts,
                         doc_seg)
    dev = nwk_shard.device
    vpiece = scatter_piece(tb)
    n_pieces = nb * (tb // vpiece) + -(-n_doc // _DOC_PIECE)
    # one allocation: the term table (16-byte aligned at the start; rows of
    # k rounded up to csrc/emsweep.cu's kChunk, 8), the pieces' metadata
    # (int4) and partial sums, then the outputs, which the kernel's first
    # launch zeroes
    n_term = shard_v * -(-k // 8) * 8
    n_scratch = n_term + n_pieces * (4 + 2 * k)
    buf = torch.empty(n_scratch + k * shard_v + d_pad * k, dtype=f32,
                      device=dev)
    nwk_out = buf[n_scratch:n_scratch + k * shard_v].view(k, shard_v)
    ndk_out = buf[n_scratch + k * shard_v:].view(d_pad, k)
    ptr = buf.data_ptr()
    err = _build.load_library("emsweep").stc_em_sweep_fused(
        nwk_shard.data_ptr(), docf_kd.data_ptr(), inv_denom.data_ptr(),
        lids.data_ptr(), seg.data_ptr(), cts.data_ptr(),
        block_vtile.data_ptr(), doc_cols.data_ptr(), doc_cts.data_ptr(),
        doc_seg.data_ptr(), nb, tb, vpiece, n_doc, _DOC_PIECE, k, vt, d_pad,
        shard_v, eta_m1, nwk_out.data_ptr(), ndk_out.data_ptr(), ptr,
        ptr + 4 * n_term, ptr + 4 * (n_term + 4 * n_pieces),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "em_sweep_fused")
    _build.count_launch(
        "em_sweep_fused",
        lambda: cost(nwk_shard, docf_kd, inv_denom, lids, seg, cts,
                     block_vtile, d_pad=d_pad, shard_v=shard_v, live=live),
        4 * n_scratch)
    return nwk_out, ndk_out
