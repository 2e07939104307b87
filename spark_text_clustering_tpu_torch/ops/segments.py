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

On the card one CTA of a fixed size takes one document, sums in a fixed
order and uses nothing atomic, so a document's bytes follow from its own
tokens alone, wherever it sits in whatever batch (the serving contract:
a served answer equals ``score --per-doc-convergence`` byte for byte on the
same device).  The kernel and the plain version differ in summation order
and in digamma (the kernel's is ``digamma.cuh``'s series), so they agree
to a tolerance, not in bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .estep import _prep_alpha
from .lda_math import segments_distribution_plain

__all__ = [
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


def topic_inference_segments(
    eb_tok: torch.Tensor,    # [T, k] gathered exp(E[log beta])
    cts: torch.Tensor,       # [T]
    offsets: torch.Tensor,   # [B + 1] int32
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
) -> torch.Tensor:
    """Per-document distributions [B, k].  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (a k past the
    kernel's limit raises ``KernelError``).  ``offsets`` are trusted: the
    packer that made the batch made them."""
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
    out = torch.empty((b, k), dtype=torch.float32, device=eb_tok.device)
    if b == 0:
        return out
    ratio = (torch.empty(max(1, t), dtype=torch.float32,
                         device=eb_tok.device)
             if lib.stc_segments_scratch_per_token(k) else None)
    err = lib.stc_topic_inference_segments(
        eb_tok.data_ptr(), cts.data_ptr(), offsets.data_ptr(),
        alpha.data_ptr(), gamma0.data_ptr(), b, k, max_inner, tol,
        out.data_ptr(), None if ratio is None else ratio.data_ptr(),
        torch.cuda.current_stream(eb_tok.device).cuda_stream,
    )
    _build.check(err, "topic_inference_segments")
    _build.count_launch("topic_inference_segments")
    return out


def pack_offsets(lens) -> np.ndarray:
    """[len(lens) + 1] int32 doc offsets of contiguous documents."""
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off.astype(np.int32)
