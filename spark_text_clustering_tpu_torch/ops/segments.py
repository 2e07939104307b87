"""Per-document convergence over a token-packed batch: the frozen gamma
fixed point of scoring, then each document's topic distribution.

``topic_inference_segments`` launches the CUDA kernel (``csrc/segments.cu``)
for tensors on the card and runs ``topic_inference_segments_plain`` for
tensors on the CPU: the plain code of ``lda_math.topic_inference_segments(
freeze=True)`` over the same batch.  Documents are contiguous from slot 0:
doc d holds the token slots [offsets[d], offsets[d+1]); slots past
offsets[-1] are pads, which the kernel never reads and the plain version
gives to doc 0 with weight 0.  Each document iterates

    gamma <- alpha + exp(E[log theta]) * sum over its tokens of
             eb * cts / phinorm,   phinorm = eb . exp(E[log theta]) + 1e-30

until its own mean|delta gamma| over k drops below ``tol`` (the update that
converged it is kept) or at ``max_inner``; its distribution is gamma over
its sum, or uniform for a document with no weight.

On the card a cluster of C CTAs takes one document.  The document is cut
into pieces of a fixed number of tokens from its own start; each piece's
sums and the document's sum over the pieces run in one fixed order, and
nothing is atomic, so a document's bytes follow from its own tokens alone,
wherever it sits in whatever batch and whatever C the launch takes (the
serving contract: a served answer equals ``score --per-doc-convergence``
byte for byte on the same device).  C is a choice of launch geometry
(``cluster_size``), not of arithmetic.  The kernel and the plain version
differ in summation order and in digamma (the kernel's is
``digamma.cuh``'s series), so they agree to a tolerance, not in bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, estep
from .estep import _prep_alpha
from .lda_math import segments_distribution_plain

__all__ = [
    "cluster_size",
    "cost",
    "launch_plan",
    "offsets_to_seg",
    "pack_offsets",
    "topic_inference_segments",
    "topic_inference_segments_plain",
]


def offsets_to_seg(offsets: torch.Tensor, t: int) -> torch.Tensor:
    """The [T] doc position of every slot (pads past offsets[-1]: 0), the
    plain version's ``seg``."""
    off = offsets.long()
    lens = off[1:] - off[:-1]
    seg = torch.zeros(t, dtype=torch.long, device=offsets.device)
    n = int(off[-1])
    seg[:n] = torch.repeat_interleave(
        torch.arange(lens.numel(), device=offsets.device), lens)
    return seg


def topic_inference_segments_plain(
    eb_tok: torch.Tensor,    # [T, k] gathered exp(E[log beta])
    cts: torch.Tensor,       # [T]
    offsets: torch.Tensor,   # [B + 1]
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    with_iters: bool = False,
):
    """The kernel's function in plain PyTorch: distributions [B, k]; with
    ``with_iters``, also the iterations each document ran [B]."""
    seg = offsets_to_seg(offsets, eb_tok.shape[0])
    return segments_distribution_plain(
        eb_tok, cts, seg, alpha, gamma0, max_inner, tol, freeze=True,
        with_iters=with_iters)


def cost(eb_tok, cts, offsets, alpha, gamma0, max_inner: int = 100,
         tol: float = 1e-3, *, lens=None, iters=None):
    """(bytes, flops) of one launch on these inputs, shapes only: each
    live token's eb row and count, the offsets, alpha, gamma0 and the
    output once; 4k + 2 flops a live token an iteration.  ``lens``: each
    doc's tokens [B] (default: all T slots live, pads included);
    ``iters``: each doc's iterations (default: one)."""
    t, k = eb_tok.shape
    b = gamma0.shape[0]
    if lens is None:
        live, work = t, float(t)
    else:
        n = _build.host_counts(lens, b, 0)
        live = int(n.sum())
        work = float((_build.host_counts(iters, b, 1) * n).sum())
    return (4 * (live * (k + 1) + (b + 1) + k + 2 * b * k),
            work * (4 * k + 2))


_MAX_CLUSTER = 16
# (device index, k, T, doc slots) -> the cluster size the rule picked
_CLUSTERS = {}


def cluster_size(n_slots: int, sms: int, fits=None) -> int:
    """CTAs a document: the largest power of two <= 16 with ``n_slots *
    size <= sms`` and, where ``fits`` is given, ``fits(size)`` (the card
    can run all the launch's clusters of that size at once); 1 where none
    is.  A choice of speed only: the bytes are the same for every size."""
    size = _MAX_CLUSTER
    while size > 1 and (n_slots * size > sms
                        or (fits is not None and not fits(size))):
        size //= 2
    return size


def _pick_cluster(lib, dev, k: int, t: int, b: int) -> int:
    """``cluster_size``'s rule for a launch of ``b`` doc slots over ``t``
    token slots, against the card's count of the clusters it can place at
    the library's shared-memory budget; asked once per key."""
    key = (dev.index, k, t, b)
    size = _CLUSTERS.get(key)
    if size is None:
        cap = lib.stc_segments_smem_budget()

        def fits(c):
            n = lib.stc_segments_active_clusters(k, t, c, cap)
            if n < 0:
                raise _build.KernelError(
                    f"topic_inference_segments: the card's cluster query "
                    f"failed: CUDA error {-n}")
            return n >= b

        size = _CLUSTERS[key] = cluster_size(b, estep._sm_count(dev), fits)
    return size


def launch_plan(k: int, t: int, b: int, device, cluster=None) -> dict:
    """How the kernel lays out a launch of ``b`` doc slots over ``t`` token
    slots on ``device``: {"cluster", "smem_bytes", "stage_pieces" (pieces a
    CTA keeps in shared memory), "piece_tokens"}."""
    lib = _build.load_library("segments")
    c = cluster or _pick_cluster(lib, torch.device(device), k, t, b)
    cap = lib.stc_segments_smem_budget()
    return {"cluster": c,
            "smem_bytes": lib.stc_segments_smem_bytes(k, t, c, cap),
            "stage_pieces": lib.stc_segments_stage_pieces(k, t, c, cap),
            "piece_tokens": lib.stc_segments_piece_tokens(k)}


def topic_inference_segments(
    eb_tok: torch.Tensor,    # [T, k] gathered exp(E[log beta])
    cts: torch.Tensor,       # [T]
    offsets: torch.Tensor,   # [B + 1] int32
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    *,
    cluster=None,
) -> torch.Tensor:
    """Per-document distributions [B, k].  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (a k past the
    kernel's limit, or a cluster size other than 1, 2, 4, 8 or 16, raises
    ``KernelError``).  ``cluster`` forces the CTAs a document (None:
    ``cluster_size``'s rule); it changes no byte.  ``offsets`` are
    trusted: the packer that made the batch made them."""
    if eb_tok.device.type == "cpu":
        return topic_inference_segments_plain(
            eb_tok, cts, offsets, alpha, gamma0, max_inner, tol)
    t, k = eb_tok.shape
    b = gamma0.shape[0]
    alpha = _prep_alpha(alpha, k, eb_tok.device)
    if cts.shape != (t,) or offsets.shape != (b + 1,) or (
        gamma0.shape != (b, k)
    ):
        raise ValueError(
            f"shapes eb_tok{tuple(eb_tok.shape)} cts{tuple(cts.shape)} "
            f"offsets{tuple(offsets.shape)} gamma0{tuple(gamma0.shape)} do "
            f"not agree")
    if eb_tok.dtype != torch.float32 or cts.dtype != torch.float32 or (
        gamma0.dtype != torch.float32
    ) or offsets.dtype != torch.int32:
        raise TypeError("topic_inference_segments takes float32 eb_tok/cts/"
                        "gamma0 and int32 offsets")
    _build.check_tensors("topic_inference_segments", eb_tok, cts, offsets,
                         alpha, gamma0)
    lib = _build.load_library("segments")
    max_k = lib.stc_segments_max_k()
    if k > max_k:
        raise _build.KernelError(
            f"topic_inference_segments: the kernel takes k <= {max_k}, got "
            f"k={k}")
    max_c = lib.stc_segments_max_cluster()
    if cluster is not None and (not 1 <= cluster <= max_c
                                or cluster & (cluster - 1)):
        raise _build.KernelError(
            f"topic_inference_segments: a cluster of a power of two <= "
            f"{max_c} CTAs, got {cluster}")
    out = torch.empty((b, k), dtype=torch.float32, device=eb_tok.device)
    if b == 0:
        return out
    t = max(1, t)
    c = cluster or _pick_cluster(lib, eb_tok.device, k, t, b)
    cap = lib.stc_segments_smem_budget()
    n_scratch = lib.stc_segments_scratch_floats(k, t, b, c, cap)
    scratch = (torch.empty(n_scratch, dtype=torch.float32,
                           device=eb_tok.device) if n_scratch > 0 else None)
    err = lib.stc_topic_inference_segments(
        eb_tok.data_ptr(), cts.data_ptr(), offsets.data_ptr(),
        alpha.data_ptr(), gamma0.data_ptr(), b, k, t, c, cap, max_inner, tol,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(eb_tok.device).cuda_stream,
    )
    _build.check(err, "topic_inference_segments")
    _build.count_launch(
        "topic_inference_segments",
        lambda: cost(eb_tok, cts, offsets, alpha, gamma0, max_inner, tol),
        0 if scratch is None else _build.nbytes(scratch))
    return out


def pack_offsets(lens) -> np.ndarray:
    """[len(lens) + 1] int32 doc offsets of contiguous documents."""
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off.astype(np.int32)
