"""One fused EM sweep over the vocab-sorted packed corpus.

Per token of the plan layout (``emscatter.plan_em_scatter``):

    term = N_wk[:, tile * vt + lid] + eta - 1
    doc  = (N_dk + alpha - 1)[seg]
    phi  = term * doc * inv_denom, normalized over k;  wphi = cts * phi

and the sweep returns N_wk' [k, shard_v] and N_dk' [d_pad, k].  Pad slots
(lid == -1, cts == 0) add exactly 0.  ``em_sweep_fused`` launches the CUDA
kernel (``csrc/emsweep.cu``) for tensors on the card and runs
``em_sweep_fused_plain`` for CPU tensors.

``fused_eligible`` is the one fused-vs-two-stage predicate: the doc axis
must be at most ``MAX_FUSED_DOC_SLOTS`` (the JAX package's bound, so both
packages take the same branch on the same corpus) and, on the card, the
kernel's shared memory (the N_wk tile, its accumulator, the doc factor and
one [d_pad, k] N_dk copy per warp) must fit a block's 227 KB with at least
one warp.  That layout is written down once, in the kernel's source, which
the gate asks (``stc_em_sweep_warps``); the plain version has no such
limit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .emscatter import _VT

__all__ = [
    "MAX_FUSED_DOC_SLOTS",
    "em_sweep_fused",
    "em_sweep_fused_plain",
    "fused_d_pad",
    "fused_eligible",
]

MAX_FUSED_DOC_SLOTS = 512


def fused_d_pad(d_max: int) -> int:
    """Doc-slot axis padded to a multiple of 8."""
    return max(8, -(-d_max // 8) * 8)


def fused_eligible(d_max: int, k: int, device: torch.device,
                   vt: int = _VT) -> bool:
    """True when the fused sweep takes this geometry on ``device`` (else
    two-stage)."""
    if d_max > MAX_FUSED_DOC_SLOTS:
        return False
    if device.type == "cpu":
        return True
    lib = _build.load_library("emsweep")
    return lib.stc_em_sweep_warps(k, vt, fused_d_pad(d_max)) > 0


def em_sweep_fused_plain(
    nwk_shard: torch.Tensor,    # [k, shard_v]
    docf_kd: torch.Tensor,      # [k, d_pad] (N_dk + alpha - 1)^T, padded
    inv_denom: torch.Tensor,    # [k]
    lids: torch.Tensor,         # [nb, 1, tb] int32 (pad -1)
    seg: torch.Tensor,          # [nb, 1, tb] int32
    cts: torch.Tensor,          # [nb, 1, tb] f32 (pad 0)
    block_vtile: torch.Tensor,  # [nb] int32
    *,
    n_vtiles: int,
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
    *,
    n_vtiles: int,
    nb: int,
    vt: int,
    tb: int,
    d_pad: int,
    shard_v: int,
    eta_m1: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM sweep over the sorted token blocks: (N_wk' [k, shard_v],
    N_dk' [d_pad, k]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if nwk_shard.device.type == "cpu":
        return em_sweep_fused_plain(
            nwk_shard, docf_kd, inv_denom, lids, seg, cts, block_vtile,
            n_vtiles=n_vtiles, vt=vt, tb=tb, d_pad=d_pad, shard_v=shard_v,
            eta_m1=eta_m1,
        )
    k = nwk_shard.shape[0]
    plan_shape = (nb, 1, tb)
    if (
        nwk_shard.shape != (k, shard_v) or docf_kd.shape != (k, d_pad)
        or inv_denom.shape != (k,) or lids.shape != plan_shape
        or seg.shape != plan_shape or cts.shape != plan_shape
        or block_vtile.shape != (nb,)
    ):
        raise ValueError("em_sweep_fused: shapes do not match the plan")
    floats = (nwk_shard, docf_kd, inv_denom, cts)
    ints = (lids, seg, block_vtile)
    if any(t.dtype != torch.float32 for t in floats) or any(
        t.dtype != torch.int32 for t in ints
    ):
        raise TypeError("em_sweep_fused takes f32 counts and i32 maps")
    _build.check_tensors("em_sweep_fused", *floats, *ints)
    lib = _build.load_library("emsweep")
    if lib.stc_em_sweep_warps(k, vt, d_pad) == 0:
        raise ValueError(
            f"em_sweep_fused: k={k}, d_pad={d_pad} exceed shared memory; "
            "use the two-stage sweep"
        )
    dev = nwk_shard.device
    nwk_out = torch.empty((k, shard_v), dtype=torch.float32, device=dev)
    ndk_part = torch.empty((n_vtiles, d_pad, k), dtype=torch.float32,
                           device=dev)
    ndk_out = torch.empty((d_pad, k), dtype=torch.float32, device=dev)
    err = lib.stc_em_sweep_fused(
        nwk_shard.data_ptr(), docf_kd.data_ptr(), inv_denom.data_ptr(),
        lids.data_ptr(), seg.data_ptr(), cts.data_ptr(),
        block_vtile.data_ptr(), nb, tb, k, vt, n_vtiles, d_pad, shard_v,
        eta_m1, nwk_out.data_ptr(), ndk_part.data_ptr(), ndk_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "em_sweep_fused")
    _build.count_launch("em_sweep_fused")
    return nwk_out, ndk_out
