"""Gamma fixed point of the LDA E-step in the padded [B, k, L] layout.

``gamma_fixed_point_bkl`` launches the CUDA kernel (``csrc/estep.cu``) for
tensors on the card and runs ``gamma_fixed_point_bkl_plain``, the same
function in plain PyTorch, for tensors on the CPU.  Both stop a tile of
``tile_b`` docs when its worst mean|delta gamma| drops below ``tol`` (or
at ``max_inner``), pad the batch to a tile multiple with empty docs, and
use the same ``digamma_approx``.  ``gamma_fixed_point`` is the [B, L, k]
slab contract of the scoring path.

On the card a tile is one thread-block cluster whose CTAs split L;
``cluster_size`` picks how many CTAs from the tile count and L.  Any k
runs on the card up to the largest the library reports
(``stc_estep_max_k``, from the size of the wide instance's state in
shared memory); past it the wrapper raises ``ValueError`` naming it.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = [
    "cluster_size",
    "digamma_approx",
    "gamma_fixed_point",
    "gamma_fixed_point_bkl",
    "gamma_fixed_point_bkl_plain",
]

_PHI_EPS = 1e-30
# CTAs a tile's cluster may have (16 needs the card's non-portable
# cluster size), and the fewest slots of L one CTA of a cluster takes
_MAX_CLUSTER = 16
_L_SLICE = 128
_H100_SMS = 132


def cluster_size(n_tiles: int, l: int, sms: int = _H100_SMS) -> int:
    """CTAs per tile of the E-step kernel: the smallest power of two with
    ``n_tiles * size >= sms``, at most 16 and at most the number of
    ``_L_SLICE``-slot slices of L (so no CTA gets less than one slice)."""
    slices = max(1, -(-l // _L_SLICE))
    size = 1
    while size < _MAX_CLUSTER and n_tiles * size < sms and 2 * size <= slices:
        size *= 2
    return size


def digamma_approx(x: torch.Tensor) -> torch.Tensor:
    """psi(x) for x > 0: the recurrence psi(x) = psi(x+1) - 1/x unrolled
    6x pushes the argument above 6, then the asymptotic series
    ln x - 1/(2x) - 1/(12x^2) + 1/(120x^4) - 1/(252x^6)."""
    res = torch.zeros_like(x)
    for _ in range(6):
        small = x < 6.0
        res = res - torch.where(small, 1.0 / x, torch.zeros_like(x))
        x = torch.where(small, x + 1.0, x)
    inv = 1.0 / x
    inv2 = inv * inv
    series = (
        torch.log(x)
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0)))
    )
    return res + series


def _prep_alpha(alpha, k: int, device) -> torch.Tensor:
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return torch.broadcast_to(a, (k,)).contiguous()


def gamma_fixed_point_bkl_plain(
    eb: torch.Tensor,        # [B, k, L]
    cts: torch.Tensor,       # [B, L]
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    tile_b: int = 8,
    with_iters: bool = False,
):
    """The kernel's function in plain PyTorch.  All tiles iterate together;
    a tile stops updating the iteration its worst doc converges.  With
    ``with_iters``, also returns the iterations each tile ran [n_tiles]."""
    b, k, l = eb.shape
    alpha = _prep_alpha(alpha, k, eb.device)
    tb = min(tile_b, b)
    pad = (-b) % tb
    if pad:  # pad docs: cts == 0, gamma0 == 1, as the kernel sees them
        eb = torch.cat([eb, eb.new_zeros(pad, k, l)])
        cts = torch.cat([cts, cts.new_zeros(pad, l)])
        gamma0 = torch.cat([gamma0, gamma0.new_ones(pad, k)])
    n_tiles = (b + pad) // tb
    gamma = gamma0.clone()
    active = torch.ones(n_tiles, dtype=torch.bool, device=eb.device)
    iters = torch.zeros(n_tiles, dtype=torch.int64, device=eb.device)
    for _ in range(max_inner):
        elog = digamma_approx(gamma) - digamma_approx(
            gamma.sum(dim=1, keepdim=True)
        )
        et = torch.exp(elog)                                     # [Bp, k]
        phinorm = (eb * et[:, :, None]).sum(dim=1) + _PHI_EPS    # [Bp, L]
        ratio = cts / phinorm
        g_new = alpha + et * (eb * ratio[:, None, :]).sum(dim=2)
        worst = (g_new - gamma).abs().mean(dim=1).view(n_tiles, tb).amax(1)
        rows = active.repeat_interleave(tb)
        gamma = torch.where(rows[:, None], g_new, gamma)
        iters += active
        active = active & (worst >= tol)
        if not bool(active.any()):
            break
    return (gamma[:b], iters) if with_iters else gamma[:b]


def gamma_fixed_point_bkl(
    eb: torch.Tensor,        # [B, k, L] gathered exp(E[log beta])
    cts: torch.Tensor,       # [B, L]
    alpha,                   # [k] or scalar
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    tile_b: int = 8,
) -> torch.Tensor:
    """Converged gamma [B, k].  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if eb.device.type == "cpu":
        return gamma_fixed_point_bkl_plain(
            eb, cts, alpha, gamma0, max_inner, tol, tile_b
        )
    b, k, l = eb.shape
    alpha = _prep_alpha(alpha, k, eb.device)
    if cts.shape != (b, l) or gamma0.shape != (b, k):
        raise ValueError(
            f"shapes eb{tuple(eb.shape)} cts{tuple(cts.shape)} "
            f"gamma0{tuple(gamma0.shape)} do not agree"
        )
    if eb.dtype != torch.float32 or cts.dtype != torch.float32 or (
        gamma0.dtype != torch.float32
    ):
        raise TypeError("gamma_fixed_point_bkl takes float32 tensors")
    _build.check_tensors("gamma_fixed_point_bkl", eb, cts, alpha, gamma0)
    return _launch(eb, cts, alpha, gamma0, max_inner, tol, min(tile_b, b))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(eb, cts, alpha, gamma0, max_inner, tol, tb):
    """The kernel on checked card tensors."""
    b, k, l = eb.shape
    lib = _build.load_library("estep")
    max_k, max_tb = lib.stc_estep_max_k(), lib.stc_estep_max_tile_b()
    if k > max_k or not 1 <= tb <= max_tb:
        raise ValueError(f"kernel takes k <= {max_k} and 1 <= tile_b <= "
                         f"{max_tb}; got k={k}, tile_b={tb}")
    out = torch.empty((b, k), dtype=torch.float32, device=eb.device)
    if b == 0:
        return out
    cs = cluster_size(-(-b // tb), l, _sm_count(eb.device))
    err = lib.stc_gamma_fixed_point_bkl(
        eb.data_ptr(), cts.data_ptr(), alpha.data_ptr(), gamma0.data_ptr(),
        b, k, l, tb, cs, max_inner, tol, out.data_ptr(),
        torch.cuda.current_stream(eb.device).cuda_stream,
    )
    _build.check(err, "gamma_fixed_point_bkl")
    _build.count_launch("gamma_fixed_point_bkl")
    return out


def gamma_fixed_point(
    eb: torch.Tensor,        # [B, L, k]
    cts: torch.Tensor,       # [B, L]
    alpha,
    gamma0: torch.Tensor,    # [B, k]
    max_inner: int = 100,
    tol: float = 1e-3,
    tile_b: int = 8,
) -> torch.Tensor:
    """The [B, L, k] slab contract: one relayout to [B, k, L], then the
    kernel (or, on the CPU, its plain version)."""
    return gamma_fixed_point_bkl(
        eb.permute(0, 2, 1).contiguous(), cts.contiguous(), alpha,
        gamma0.contiguous(), max_inner, tol, tile_b,
    )
