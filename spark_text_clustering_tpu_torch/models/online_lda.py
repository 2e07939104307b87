"""Online variational-Bayes LDA on one device: MLlib's
``OnlineLDAOptimizer`` on every single-device path of the JAX package's
online fit, chosen by the same rules.

The minibatch: ``sampling="bernoulli"`` (MLlib's per-doc Bernoulli(f),
the batch padded to its 4-sigma bound), ``"fixed"`` (round(f n) docs
without replacement) or ``"epoch"`` (shuffled passes over the corpus).
``sample_pick(it)`` is that numpy stream, pure in (seed, it) and equal to
the JAX package's; picks are padded with the ids n, n+1, ... which read
nothing.

The paths, in the order ``fit`` tries them:

* tiles-resident (``sampling="epoch"`` with ``token_layout="tiles"``, or
  "auto" where the padded row is at least 4x the mean doc): the corpus is
  tiled once (``ops.packed.plan_corpus_tiles``) and kept on the device,
  and an iteration draws a block-stratified epoch minibatch of whole
  tiles; ``tiles_iteration``;
* packed, host-streaming (``"packed"``, or "auto" with that padding
  waste): each minibatch is gathered on the host into flat token arrays,
  then on the card cut into tiles (``plan_tile_pack_uniform``) for
  ``tiles_iteration``, on the CPU run by the flat segment loop
  ``packed_iteration``;
* padded (otherwise): the corpus [n+1, row_len] uploaded once
  (``device_resident``), or each minibatch grouped into power-of-two
  length buckets on the host; ``padded_estep`` and ``padded_mstep``.

Two rules decide among them, as in the JAX package: the card follows
its TPU rule (where its kernels run: tiles planned with a 128-doc floor,
the tile kernel on both tiled paths); the CPU its non-TPU rule (tiles
planned with a 1-doc floor, "auto" leaving the tiles path when the doc
slots exceed 3n or the batch maps to fewer than 2 tiles, and the
whole-batch segment loop in place of the tile kernel).  ``rule=``
chooses either on any device.  One iteration:

    eb     = exp(E[log beta]) at the minibatch's tokens
    gamma  = the gamma fixed point: the tile kernel
             (``gamma_fixed_point_tiles``) or the padded E-step kernel
             (``gamma_fixed_point_bkl``), each the CUDA kernel on the card
             and its plain version on the CPU, or the segment loop
    sstats = sum over tokens of exp(E[log theta]) * cts / phinorm * eb,
             scattered into [k, V]
    lambda <- (1 - rho) lambda + rho (eta + D / |B| sstats),
             rho = (tau0 + t + 1)^-kappa; skipped for an empty minibatch

Random draws come from explicit ``torch.Generator``s on ``rng_device``
(the fit's device unless asked otherwise): lambda from one seeded by
(seed, 0xFFFF), and each iteration's gamma inits from one Gamma table
[n+1, k] seeded by (seed, 0x6A33, step) and indexed by each doc's global
id (pad ids read row n), so a doc's init depends on (seed, step, doc)
only, on every path and grid.  A fit resumes from
``<checkpoint_dir>/train_state.npz`` (lam [k, V_pad], step): the JAX
package's checkpoint.

On a ``parallel.ProcessGrid`` of ``data x model`` ranks, as in the JAX
package, lambda is cut over the vocabulary on "model" (zero columns pad V
to V_pad, a multiple of the model shards, and lambda is drawn and
checkpointed at that width) and the minibatch over "data" (``bsz`` rounded
up to a multiple of the data shards).  Each rank gathers lambda at its
tokens from the vocabulary shards (``gather_model_rows_kbl`` /
``gather_model_rows_bkl``), runs its kernel on its own tiles or rows,
scatters the statistics into its vocabulary shard, and one ``psum_data``
an iteration sums them; the flat packed path also sums each inner
iteration's per-doc sums over "data".  The tiles-resident path keeps each
data rank's block of tiles on its device and walks a block-stratified
epoch stream over that shard's real tiles; the padded-resident path
keeps each data rank's rows and assembles a minibatch with one
``psum_data`` of the picked rows each rank owns.  Rank 0 alone writes
checkpoints; every rank returns the same model.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Params
from ..device import resolve_device
from ..ops.estep import gamma_fixed_point_bkl
from ..ops.lda_math import (
    dirichlet_expectation,
    dirichlet_expectation_sharded,
    gamma_fixed_point_segments,
    init_gamma,
    init_lambda,
    seeded_generator,
    token_sstats_factors_bkl,
    token_sstats_factors_segments,
)
from ..ops.packed import (
    docs_gamma_to_tiles,
    gamma_fixed_point_tiles,
    plan_corpus_tiles,
    plan_tile_pack_uniform,
)
from ..ops.sparse import batch_from_rows, next_pow2
from ..parallel.collectives import (
    fetch_global,
    gather_model_rows_bkl,
    gather_model_rows_kbl,
    model_handoff,
    note_host_handoff,
    model_row_sum,
    psum_data,
    scatter_add_model_shard,
    scatter_add_model_shard_bkl,
)
from ..parallel.mesh import agree_checkpoint_exists, is_coordinator, make_grid
from ..utils.timing import IterationTimer
from .base import LDAModel
from .persistence import load_train_state, save_train_state

__all__ = [
    "OnlineLDA",
    "packed_iteration",
    "padded_estep",
    "padded_iteration",
    "padded_mstep",
    "tiles_iteration",
]

_PHI_EPS = 1e-30
_LAMBDA_KEY = 0xFFFF     # lambda's generator: (seed, 0xFFFF)
_GAMMA_KEY = 0x6A33      # step t's gamma inits: (seed, 0x6A33, t)
_TILE_EPOCH_KEY = 0x71E5  # the tile sampler's numpy stream, as in JAX
_DOC_EPOCH_KEY = 0xE90C   # the doc-level epoch stream, as in JAX
_RULES = ("card", "cpu")
# the JAX package's device-sync label of each chunked path (the packed
# path's follows the gamma backend of its last chunk)
_SYNC_LABELS = {"tiles-resident": "online_tiles",
                "padded-resident": "online_resident"}
# the JAX package's dispatch label of each path's chunk (its verbose
# padded-resident fit dispatches one step an iteration)
_DISPATCH_LABELS = {"tiles-resident": "online.tiles_resident_chunk",
                    "padded-resident": "online.resident_chunk"}
# the packed path's chunk, by the layout it took
_packed_tiles_run = telemetry.instrument_dispatch(
    "online.packed_tiles_chunk", lambda lam, step, m, work: work(lam))
_packed_flat_run = telemetry.instrument_dispatch(
    "online.packed_chunk", lambda lam, step, m, work: work(lam))
# the padded host path's three dispatches an iteration
_eb_run = telemetry.instrument_dispatch("online.eb", lambda lam, grid:
                                        _eb_table(lam, grid))


def _rho_scale(step: int, tau0: float, kappa: float, corpus_size: float,
               batch_docs: int) -> Tuple[np.float32, np.float32]:
    """rho_t = (tau0 + t + 1)^-kappa and D / |B|, in float32 as in JAX."""
    rho = np.float32(
        (np.float32(tau0) + np.float32(step) + np.float32(1.0))
        ** np.float32(-kappa))
    return rho, np.float32(corpus_size) / np.float32(max(batch_docs, 1))


def _blend_touched(lam, touched, step, batch_docs, *, eta, tau0, kappa,
                   corpus_size):
    """The packed paths' M-step, affine in lambda: (1 - rho) lambda +
    rho eta + rho (D/|B|) touched, where ``touched`` is sstats * eb."""
    rho, scale = _rho_scale(step, tau0, kappa, corpus_size, batch_docs)
    lam_new = lam * float(np.float32(1.0) - rho) + float(rho * np.float32(eta))
    return lam_new.add_(touched, alpha=float(rho * scale))


def _eb_at(lam: torch.Tensor, flat: torch.Tensor, grid=None) -> torch.Tensor:
    """exp(E[log beta]) at the token ids ``flat``: [k, T], from lambda's
    columns there and its row sums (the full [k, V] never forms; on a
    grid both come from the vocabulary shards)."""
    if grid is None:
        lam_tok, row_sum = lam[:, flat], lam.sum(dim=1)
    else:
        lam_tok = gather_model_rows_kbl(grid, lam, flat)
        row_sum = model_row_sum(grid, lam)
    return torch.exp(torch.digamma(lam_tok.clamp(min=1e-30))
                     - torch.digamma(row_sum)[:, None])


def _eb_table(lam: torch.Tensor, grid=None) -> torch.Tensor:
    """exp(E[log beta]) over lambda's columns (this rank's shard)."""
    if grid is None:
        return torch.exp(dirichlet_expectation(lam))
    return torch.exp(dirichlet_expectation_sharded(lam,
                                                   model_row_sum(grid, lam)))


def _touched(lam: torch.Tensor, flat: torch.Tensor, vals_kt: torch.Tensor,
             grid=None) -> torch.Tensor:
    """Token values [k, T] added into lambda's columns: on a grid into
    this rank's vocabulary shard, then summed over the data shards."""
    if grid is None:
        return torch.zeros_like(lam).index_add_(1, flat, vals_kt)
    return psum_data(grid, scatter_add_model_shard(grid, flat, vals_kt.T,
                                                   lam.shape[1]))


def tiles_iteration(
    lam: torch.Tensor,           # [k, V]
    step: int,
    ids_t: torch.Tensor,         # [tb, tt] int32 token ids of the tiles
    cts_t: torch.Tensor,         # [tb, tt] float32
    seg_t: torch.Tensor,         # [tb, tt] int32 tile-local doc slots
    gamma0: torch.Tensor,        # [k, tb * d] gamma inits in slot order
    batch_docs: int,             # docs the minibatch counts
    *,
    alpha: torch.Tensor,
    eta: float,
    tau0: float,
    kappa: float,
    d: int,
    corpus_size: float,
    max_inner: int = 100,
    tol: float = 1e-3,
    per_tile_stop: bool = True,
    grid=None,
) -> torch.Tensor:
    """One online-VB update from a minibatch of tiles; returns the new
    lambda (the input is not modified).  The JAX package's tiles
    iterations (resident and host-streaming): the gamma fixed point is the
    tile kernel, or with ``per_tile_stop=False`` its whole-batch segment
    twin over the tile slots (the JAX package's non-TPU loop); the rest is
    plain torch, as JAX leaves it to XLA.  On a ``grid`` the tiles are
    this rank's, ``lam`` its vocabulary shard and ``batch_docs`` the
    whole minibatch's: no doc straddles a tile, so gamma needs no
    collective, and the statistics one ``psum_data``."""
    if batch_docs <= 0:
        return lam                     # MLlib skips an empty minibatch
    tb = ids_t.shape[0]
    flat = ids_t.reshape(-1).long()
    eb_kt = _eb_at(lam, flat, grid)                            # [k, T]
    tile = torch.arange(tb, device=seg_t.device)[:, None]
    slot = (tile * d + seg_t.clamp(max=d - 1)).reshape(-1)     # [T]
    if per_tile_stop:
        gamma_tiles = gamma_fixed_point_tiles(
            eb_kt, cts_t, seg_t, alpha, gamma0, d, max_inner, tol
        )                                                      # [k, tb*d]
    else:
        # pad tokens (cts == 0) add nothing on the slot they clamp to
        gamma_s, _ = gamma_fixed_point_segments(
            eb_kt.T, cts_t.reshape(-1), slot, alpha, gamma0.T, max_inner,
            tol)
        gamma_tiles = gamma_s.T
    exp_et = torch.exp(
        torch.digamma(gamma_tiles)
        - torch.digamma(gamma_tiles.sum(dim=0, keepdim=True))
    )
    et_tok = exp_et[:, slot]
    # pad token slots carry cts == 0 and contribute nothing
    phinorm = (eb_kt * et_tok).sum(dim=0) + _PHI_EPS
    vals = et_tok * (cts_t.reshape(-1) / phinorm)[None, :] * eb_kt
    return _blend_touched(lam, _touched(lam, flat, vals, grid), step,
                          batch_docs, eta=eta, tau0=tau0, kappa=kappa,
                          corpus_size=corpus_size)


def packed_iteration(
    lam: torch.Tensor,           # [k, V]
    step: int,
    ids: torch.Tensor,           # [T] token ids of the minibatch
    cts: torch.Tensor,           # [T] float32
    seg: torch.Tensor,           # [T] minibatch position of each token
    gamma0: torch.Tensor,        # [B, k] gamma inits by position
    batch_docs: int,             # nonempty docs of the minibatch
    *,
    alpha: torch.Tensor,
    eta: float,
    tau0: float,
    kappa: float,
    corpus_size: float,
    max_inner: int = 100,
    tol: float = 1e-3,
    grid=None,
) -> torch.Tensor:
    """One online-VB update from a flat token-packed minibatch (the JAX
    package's ``make_online_packed_chunk``): the whole-batch segment gamma
    loop, then the affine M-step.  On a ``grid`` the tokens are this
    rank's slice of the minibatch's token slots and gamma [B, k] is the
    whole minibatch's on every rank: each inner iteration sums its per-doc
    sums over "data"."""
    if batch_docs <= 0:
        return lam
    flat = ids.long()
    eb_tok = _eb_at(lam, flat, grid).T                         # [T, k]
    reduce_fn = None if grid is None else (lambda x: psum_data(grid, x))
    gamma, _ = gamma_fixed_point_segments(eb_tok, cts, seg, alpha, gamma0,
                                          max_inner, tol, reduce_fn=reduce_fn)
    vals = token_sstats_factors_segments(eb_tok, cts, seg, gamma)
    return _blend_touched(lam, _touched(lam, flat, (vals * eb_tok).T, grid),
                          step, batch_docs, eta=eta, tau0=tau0, kappa=kappa,
                          corpus_size=corpus_size)


def padded_estep(
    eb: torch.Tensor,            # [k, V] exp(E[log beta])
    ids: torch.Tensor,           # [B, L] int32
    wts: torch.Tensor,           # [B, L] float32
    gamma0: torch.Tensor,        # [B, k]
    *,
    alpha: torch.Tensor,
    max_inner: int = 100,
    tol: float = 1e-3,
    grid=None,
) -> torch.Tensor:
    """The raw sufficient statistics [k, V] of one padded batch: eb
    gathered as [B, k, L], the padded E-step kernel (per-tile stop), the
    final responsibilities, one ``index_add_``.  On a ``grid``: this
    rank's rows, eb its vocabulary shard, the gather from every shard
    (``gather_model_rows_bkl``), and the statistics of this shard's
    columns, still to be summed over "data"."""
    b, l = ids.shape
    k = eb.shape[0]
    flat = ids.reshape(-1).long()
    if grid is None:
        eb_tok = eb[:, flat].reshape(k, b, l).transpose(0, 1).contiguous()
    else:
        eb_tok = gather_model_rows_bkl(grid, eb, ids)
    gamma = gamma_fixed_point_bkl(eb_tok, wts.contiguous(), alpha,
                                  gamma0.contiguous(), max_inner, tol)
    vals = token_sstats_factors_bkl(eb_tok, wts, gamma)        # [B, k, L]
    if grid is not None:
        return scatter_add_model_shard_bkl(grid, ids, vals, eb.shape[1])
    return torch.zeros_like(eb).index_add_(
        1, flat, vals.transpose(0, 1).reshape(k, -1))


def padded_mstep(
    lam: torch.Tensor,           # [k, V]
    eb: torch.Tensor,            # [k, V]
    sstats: torch.Tensor,        # [k, V]
    step: int,
    batch_docs: int,
    *,
    eta: float,
    tau0: float,
    kappa: float,
    corpus_size: float,
) -> torch.Tensor:
    """Hoffman's M-step: lambda_hat = eta + (D/|B|) sstats * eb, then
    (1 - rho) lambda + rho lambda_hat; lambda as it is for an empty
    minibatch."""
    if batch_docs <= 0:
        return lam
    rho, scale = _rho_scale(step, tau0, kappa, corpus_size, batch_docs)
    lam_hat = (sstats * eb).mul_(float(scale)).add_(float(np.float32(eta)))
    return lam * float(np.float32(1.0) - rho) + lam_hat.mul_(float(rho))


_estep_run = telemetry.instrument_dispatch("online.estep", padded_estep)
# the step and the minibatch's docs ride as one tensor, so every
# iteration shares a signature
_mstep_run = telemetry.instrument_dispatch(
    "online.mstep", lambda lam, eb, sstats, step_docs, **kw: padded_mstep(
        lam, eb, sstats, int(step_docs[0]), int(step_docs[1]), **kw))


def padded_iteration(
    lam: torch.Tensor,           # [k, V]
    step: int,
    ids: torch.Tensor,           # [B, L] int32
    wts: torch.Tensor,           # [B, L] float32
    gamma0: torch.Tensor,        # [B, k]
    batch_docs: int,             # docs with weight, (wts.sum(-1) > 0).sum()
    *,
    alpha: torch.Tensor,
    eta: float,
    tau0: float,
    kappa: float,
    corpus_size: float,
    max_inner: int = 100,
    tol: float = 1e-3,
    grid=None,
) -> torch.Tensor:
    """One online-VB update from a padded minibatch (the JAX package's
    resident step, ``_online_step_core``); on a ``grid``, from this
    rank's rows, ``batch_docs`` the whole minibatch's."""
    if batch_docs <= 0:
        return lam
    eb = _eb_table(lam, grid)
    sstats = padded_estep(eb, ids, wts, gamma0, alpha=alpha,
                          max_inner=max_inner, tol=tol, grid=grid)
    if grid is not None:
        sstats = psum_data(grid, sstats)
    return padded_mstep(lam, eb, sstats, step, batch_docs, eta=eta,
                        tau0=tau0, kappa=kappa, corpus_size=corpus_size)


def _online_batch_size(p: Params, n: int) -> Tuple[int, float]:
    """(docs a minibatch holds, the sampling fraction f): ``batch_size``
    docs or MLlib's fraction of the corpus (clamped to 1); under
    ``"bernoulli"`` the batch is padded to ceil(f n + 4 sqrt(f n (1 - f))
    + 1), which a draw overflows with probability ~3e-5."""
    fraction = min(
        1.0,
        p.batch_size / max(1, n) if p.batch_size is not None
        else p.mini_batch_fraction(n),
    )
    if p.sampling == "bernoulli":
        mean = fraction * n
        bsz = int(np.ceil(mean + 4.0 * np.sqrt(mean * (1 - fraction)) + 1))
        return min(bsz, n), fraction
    if p.batch_size is not None:
        return min(p.batch_size, n), fraction
    return max(1, min(n, round(fraction * n))), fraction


def _sample_stream(p: Params, n: int, bsz: int,
                   fraction: float) -> Callable[[int], np.ndarray]:
    """``sample_pick(it)``: the unpadded doc ids of iteration ``it``."""
    perms: dict = {}

    def epoch_perm(epoch: int) -> np.ndarray:
        if epoch not in perms:
            perms.clear()
            perms[epoch] = np.random.default_rng(
                (p.seed, _DOC_EPOCH_KEY, epoch)).permutation(n).astype(
                    np.int32)
        return perms[epoch]

    def sample_pick(it: int) -> np.ndarray:
        if p.sampling == "epoch":
            size = min(bsz, n)
            out = np.empty(size, np.int32)
            filled, start = 0, it * size
            while filled < size:
                epoch, off = divmod(start + filled, n)
                take = min(size - filled, n - off)
                out[filled:filled + take] = epoch_perm(epoch)[off:off + take]
                filled += take
            return out
        rng = np.random.default_rng((p.seed, it))
        if p.sampling == "bernoulli":
            return np.flatnonzero(rng.random(n) < fraction)[:bsz].astype(
                np.int32)
        return rng.choice(n, size=min(bsz, n), replace=False).astype(np.int32)

    return sample_pick


def _dispatch_interval(p: Params, ckpt_path, verbose: bool, n_iters: int,
                       bytes_per_iter: int = 0) -> int:
    """Iterations a chunk covers: 1 when each is timed, the checkpoint
    interval when checkpointing, else the whole run; capped so a chunk
    stages at most ``dispatch_budget_bytes`` (the JAX package's rule)."""
    if verbose or p.record_iteration_times:
        return 1
    cap = max(1, p.checkpoint_interval) if ckpt_path else max(1, n_iters)
    if bytes_per_iter > 0:
        cap = min(cap, max(1, p.dispatch_budget_bytes // bytes_per_iter))
    return cap


def _save_cadence(p: Params, interval: int) -> int:
    """Iterations between checkpoints for ``interval``-iteration chunks:
    ``checkpoint_interval``, or the chunk where the budget cut it
    shorter."""
    ck = max(1, p.checkpoint_interval)
    return ck if interval <= 1 or interval >= ck else interval


def _flatten(rows) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The corpus as flat (ids, cts) token arrays and [n+1] doc fences."""
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
    if not rows:
        return np.zeros(0, np.int32), np.zeros(0, np.float32), offsets
    return (np.concatenate([np.asarray(i, np.int32) for i, _ in rows]),
            np.concatenate([np.asarray(w, np.float32) for _, w in rows]),
            offsets)




@dataclass
class _Run:
    """What one fit's paths share."""

    n: int
    k: int
    v: int
    bsz: int
    n_iters: int
    start_it: int
    alpha: np.ndarray
    alpha_t: torch.Tensor
    eta: float
    lam: torch.Tensor
    ckpt_path: Optional[str]
    verbose: bool
    timer: IterationTimer
    make_pick: Callable[[int], np.ndarray]


class OnlineLDA:
    """Estimator: ``fit(rows, vocab) -> LDAModel`` with the online auto
    priors alpha = eta = 1/k.  ``rule`` is "card" (the JAX package's TPU
    rule) or "cpu" (its non-TPU rule); by default the device's.

    ``grid`` (a ``parallel.ProcessGrid``) fits on a grid of ranks, each
    rank calling ``fit`` with the same rows; without one, a ``params``
    that asks for shards takes the grid of the started world
    (``parallel.make_grid``).  Every rank returns the same model."""

    def __init__(self, params: Params, device="cuda", rng_device=None,
                 rule: Optional[str] = None, grid=None) -> None:
        if params.algorithm != "online":
            params = params.replace(algorithm="online")
        if grid is None and (params.model_shards != 1
                             or params.data_shards not in (None, 1)):
            grid = make_grid(params.data_shards, params.model_shards,
                             device=device)
        if grid is not None:
            params = params.replace(data_shards=grid.data_shards,
                                    model_shards=grid.model_shards)
            device = grid.device
        self.params = params
        self.grid = grid if grid is not None and grid.size > 1 else None
        self.device = resolve_device(device)
        self.rng_device = (
            self.device if rng_device is None else resolve_device(rng_device)
        )
        self.rule = rule or ("card" if self.device.type == "cuda" else "cpu")
        if self.rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r} (use 'card'|'cpu')")
        self.last_batch_size: Optional[int] = None
        self.last_row_len: Optional[int] = None
        self.last_layout = "padded"
        self.last_batch_cells: Optional[int] = None
        # the timed chunks (device round trips) of the last fit
        self.last_dispatches = 0
        # the gamma loop the last tiled or packed fit ran: "pallas_tiles"
        # (the tile kernel), "xla_tiles" (the segment loop over tile
        # slots), "xla" (the flat segment loop; the JAX package's names),
        # or "pallas" (the padded E-step kernel)
        self.last_gamma_backend = "xla"
        self.last_tiles: Optional[dict] = None
        # per chunk of the packed path on tiles: its geometry
        self.last_tile_chunks: List[dict] = []
        self._corpus_cache = None

    @property
    def _data(self) -> Tuple[int, int]:
        """(this rank's data shard, the data shards)."""
        g = self.grid
        return (0, 1) if g is None else (g.d, g.data_shards)

    # ------------------------------------------------------------------
    def _gamma_rows(self, run: _Run, step: int,
                    ids: torch.Tensor) -> torch.Tensor:
        """Step ``step``'s gamma inits [len(ids), k] on the fit's device,
        read from the step's Gamma table at ``ids`` (on ``rng_device``;
        ids past n read row n)."""
        p = self.params
        gen = seeded_generator(self.rng_device, p.seed, _GAMMA_KEY, step)
        table = init_gamma(gen, run.n + 1, run.k, p.gamma_shape,
                           device=self.rng_device)
        return table[ids.clamp(max=run.n).long()].to(self.device)

    def _sync(self, lam: torch.Tensor, label: str) -> None:
        """The wait for the card at the end of a chunk, under the JAX
        package's label of the path (``online_tiles``, ...)."""
        telemetry.device_sync(lam, label)

    def _save(self, run: _Run, it: int, lam: torch.Tensor) -> None:
        # a collective fetch on every rank; one writer
        lam_host = (lam.cpu().numpy() if self.grid is None
                    else fetch_global(self.grid, lam, "model"))
        if is_coordinator():
            save_train_state(run.ckpt_path, it, lam=lam_host)

    def _say(self, run: _Run, text: str) -> None:
        if run.verbose and is_coordinator():
            print(text)

    def _model(self, run: _Run, lam: torch.Tensor, vocab) -> LDAModel:
        """The fitted model, after the fit's telemetry (every layout's
        return path comes through here)."""
        telemetry.emit_fit(
            "online", run.timer.times, kind=run.timer.kind,
            start_iteration=run.start_it, layout=self.last_layout,
            gamma_backend=self.last_gamma_backend,
            batch_size=self.last_batch_size,
            batch_cells=self.last_batch_cells,
            dispatches=self.last_dispatches,
            k=self.params.k, vocab_width=run.v, docs=run.n,
        )
        if self.grid is None:
            note_host_handoff(lam.shape[0] * run.v * lam.element_size())
        return LDAModel(
            lam=(lam.cpu().numpy() if self.grid is None
                 else model_handoff(self.grid, lam, run.v)),
            vocab=list(vocab),
            alpha=run.alpha,
            eta=float(run.eta),
            gamma_shape=self.params.gamma_shape,
            iteration_times=list(run.timer.times),
            iteration_times_kind=run.timer.kind,
            algorithm="online",
            step=run.start_it + len(run.timer.times),
            device=str(self.device),
        )

    def _chunked(self, run: _Run, interval: int, chunk, label: str):
        """Iterations start..n_iters in chunks of up to ``interval``
        (``chunk(lam, it, m) -> lam``), each timed as one span and split;
        checkpoints on the JAX package's cadence.  Returns lambda."""
        lam, it = run.lam, run.start_it
        cadence = _save_cadence(self.params, interval)
        self.last_dispatches = 0
        label_d = ("online.resident_step"
                   if run.verbose and label == "padded-resident"
                   else _DISPATCH_LABELS.get(label))
        if label_d is not None:
            # one dispatch a chunk; the step rides as a tensor, so the
            # chunks of one width share a signature
            step_run = telemetry.instrument_dispatch(
                label_d, lambda lam, step, m, run_chunk=chunk: run_chunk(
                    lam, int(step), m))

            def chunk(lam, it, m):
                return step_run(lam, torch.tensor(it), m)
        while it < run.n_iters:
            m = min(interval - (it % interval), run.n_iters - it)
            run.timer.start()
            lam = chunk(lam, it, m)
            self.last_dispatches += 1
            self._sync(lam, _SYNC_LABELS.get(label) or (
                "online_tiles" if self.last_gamma_backend == "pallas_tiles"
                else "online_packed"))
            run.timer.stop()
            run.timer.split_last(m)
            self._say(run, f"iter {it}: {run.timer.times[-1]:.4f}s ({label})")
            it += m
            if run.ckpt_path and it % cadence == 0:
                self._save(run, it, lam)
        return lam

    # ---- the tiles-resident path -------------------------------------
    def _tile_corpus(self, rows, n: int, k: int, kernel: bool):
        """The corpus tile plan over the data shards and each shard's real
        tile count, cached across fits of the same corpus (keyed by
        content: doc count, token total and three sample rows), planning
        rule and grid; the resident tensors join the entry on first use.
        None when no geometry fits."""
        d_idx, n_data = self._data
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
        fp = hashlib.blake2b(digest_size=16)
        fp.update(np.int64(n).tobytes())
        fp.update(offsets[-1:].tobytes())
        for i in ((0, n // 2, n - 1) if n else ()):
            fp.update(np.asarray(rows[i][0], np.int32).tobytes())
            fp.update(np.asarray(rows[i][1], np.float32).tobytes())
        key = (fp.hexdigest(), n, int(offsets[-1]), k, kernel, n_data, d_idx,
               str(self.device), str(self.rng_device))
        if self._corpus_cache is not None and self._corpus_cache[0] == key:
            return self._corpus_cache[1]
        flat_ids, flat_cts, _ = _flatten(rows)
        # the kernel's plan keeps the JAX package's 128-doc-slot floor; its
        # segment twin has no such floor
        plan = plan_corpus_tiles(flat_ids, flat_cts, offsets, n_shards=n_data,
                                 k=k, min_tile_docs=128 if kernel else 1)
        entry = None
        if plan is not None:
            # real tiles a shard: the doc-order plan puts its pad tiles at
            # the end, so only the last shards hold them
            per = plan.ids.shape[0] // n_data
            reals = np.array([int((plan.doc_ids[s * per:(s + 1) * per, 0]
                                   < n).sum()) for s in range(n_data)])
            entry = {"plan": plan, "reals": reals, "resident": None}
        self._corpus_cache = (key, entry)
        return entry

    def _fit_tiles_resident(self, rows, vocab, run: _Run, forced: bool):
        """Device-resident tiled epoch training, or None where the JAX
        package's rule declines it (no geometry, over budget, and for
        "auto" under the CPU rule: doc slots past 3n, or fewer than 2
        tiles a minibatch a data shard)."""
        p = self.params
        n, k = run.n, run.k
        d_idx, n_data = self._data
        kernel = self.rule == "card" or forced
        entry = self._tile_corpus(rows, n, k, kernel)
        if entry is None:
            return None
        plan, reals = entry["plan"], entry["reals"]
        n_real = int(reals.sum())
        resident_bytes = (plan.ids.nbytes + plan.cts.nbytes
                          + plan.seg.nbytes + plan.doc_ids.nbytes)
        if resident_bytes > p.resident_budget_bytes:
            return None
        n_tiles = plan.ids.shape[0]
        if not kernel and n_tiles * plan.d > 3.0 * max(1, n):
            return None              # the segment twin pays for pad slots
        if n_real == 0:
            return None
        # tiles per iteration: the doc-level batch fraction in tiles,
        # spread evenly over the data shards
        tb_target = round(run.bsz / max(1, n) * n_real)
        if not forced and tb_target < 2 * n_data:
            return None
        tb_l = max(1, -(-max(n_data, tb_target) // n_data))
        per = n_tiles // n_data
        if entry["resident"] is None:
            blk = slice(d_idx * per, (d_idx + 1) * per)
            resident = tuple(
                torch.from_numpy(np.ascontiguousarray(a[blk])).to(self.device)
                for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids))
            entry["resident"] = (resident, resident[3].to(self.rng_device))
        (ids_res, cts_res, seg_res, _), doc_rng = entry["resident"]

        # each data shard's block-stratified epoch stream over its own
        # real tiles, pure in (seed, shard, it): the JAX package's stream
        perms: dict = {}

        def _perm(s: int, epoch: int) -> np.ndarray:
            if (s, epoch) not in perms:
                if len(perms) > 2 * n_data:
                    perms.clear()
                perms[s, epoch] = np.random.default_rng(
                    (p.seed, _TILE_EPOCH_KEY, s, epoch)
                ).permutation(int(reals[s])).astype(np.int32)
            return perms[s, epoch]

        def tile_pick(it: int) -> np.ndarray:
            """[data shards, tb_l] tile indices local to each shard."""
            out = np.zeros((n_data, tb_l), np.int32)
            for s, r in enumerate(reals):
                # a shard of pad tiles only picks tile 0: it adds nothing
                filled, start = 0, it * tb_l
                while r and filled < tb_l:
                    epoch, off = divmod(start + filled, int(r))
                    take = min(tb_l - filled, int(r) - off)
                    out[s, filled:filled + take] = _perm(s, epoch)[
                        off:off + take]
                    filled += take
            return out

        self.tile_pick = tile_pick
        self.last_batch_size = int(round(n * n_data * tb_l / n_real))
        self.last_layout = "tiles_resident"
        self.last_gamma_backend = "pallas_tiles" if kernel else "xla_tiles"
        self.last_batch_cells = n_data * tb_l * plan.tt
        self.last_tiles = {
            "n_tiles": int(n_tiles), "tt": plan.tt, "d": plan.d,
            "tiles_per_iter": n_data * tb_l, "reals_per_shard": reals.tolist(),
            "resident_bytes": resident_bytes,
        }
        dev, rng_dev = self.device, self.rng_device
        shard_base = (np.arange(n_data) * per)[:, None]

        def chunk(lam, it, m):
            # the chunk's picks go to the device in one copy: a copy per
            # iteration would wait for the card every iteration
            picks = np.stack([tile_pick(i) for i in range(it, it + m)])
            picks_dev = torch.from_numpy(
                np.ascontiguousarray(picks[:, d_idx])).to(dev)
            picks_rng = picks_dev.to(rng_dev)
            for j in range(m):
                pick = picks_dev[j]
                # the minibatch's docs, every shard's tiles counted
                docs = int((plan.doc_ids[(picks[j] + shard_base).reshape(-1)]
                            < n).sum())
                gamma0 = self._gamma_rows(
                    run, it + j, doc_rng[picks_rng[j]].reshape(-1)).T
                lam = tiles_iteration(
                    lam, it + j, ids_res[pick], cts_res[pick], seg_res[pick],
                    gamma0.contiguous(), docs,
                    alpha=run.alpha_t, eta=run.eta, tau0=p.tau0,
                    kappa=p.kappa, d=plan.d, corpus_size=float(n),
                    max_inner=p.estep_max_inner, tol=p.estep_tol,
                    per_tile_stop=kernel, grid=self.grid)
            return lam

        interval = _dispatch_interval(p, run.ckpt_path, run.verbose,
                                      run.n_iters, 4 * n_data * tb_l)
        lam = self._chunked(run, interval, chunk, "tiles-resident")
        return self._model(run, lam, vocab)

    # ---- the host-streaming packed path ------------------------------
    def _fit_packed(self, rows, vocab, run: _Run):
        """Each chunk's minibatches gathered on the host as flat token
        arrays, then cut into tiles for the tile kernel (the card's rule;
        the flat loop where no tile geometry fits) or run by the flat
        segment loop (the CPU's).  On a grid each data rank takes its
        block of the chunk's tiles, or its slice of the token slots."""
        p = self.params
        n, k = run.n, run.k
        d_idx, n_data = self._data
        dev, rng_dev = self.device, self.rng_device
        flat_ids, flat_cts, offsets = _flatten(rows)
        doc_lens = np.diff(offsets)
        # one corpus-wide token width, so every chunk tiles alike
        tile_tt = max(512, next_pow2(int(doc_lens.max()) if n else 0))
        use_tiles = self.rule == "card"
        kw = dict(alpha=run.alpha_t, eta=run.eta, tau0=p.tau0,
                  kappa=p.kappa, corpus_size=float(n),
                  max_inner=p.estep_max_inner, tol=p.estep_tol,
                  grid=self.grid)

        def pack(pick):
            """One minibatch -> (ids [t], cts [t], seg [t], nonempty docs):
            one ragged gather of every picked doc's tokens."""
            real_pos = np.flatnonzero(pick < n)
            real = pick[real_pos]
            lens = offsets[real + 1] - offsets[real]
            total = int(lens.sum())
            if not total:
                return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                        np.zeros(0, np.int32), int((lens > 0).sum()))
            shift = np.repeat(
                offsets[real] - np.concatenate(([0], np.cumsum(lens)[:-1])),
                lens)
            idx = np.arange(total, dtype=np.int64) + shift
            seg = np.repeat(real_pos.astype(np.int32), lens)
            return (flat_ids[idx], flat_cts[idx], seg,
                    int((lens > 0).sum()))

        cells = [0, 0]          # cells over the iterations run, iterations
        self.last_tile_chunks = []

        def tiles_chunk(lam, it, picks, packs, plan):
            m = len(packs)
            self.last_gamma_backend = "pallas_tiles"
            real_tiles = [int((plan.doc_ids[j, :, 0] < plan.b).sum())
                          for j in range(m)]
            self.last_tile_chunks.append({
                "iterations": m, "d": plan.d, "n_tiles": plan.n_tiles,
                "tt": plan.tt,
                "all_pad_share": 1.0 - sum(real_tiles) / (m * plan.n_tiles)})
            cells[0] += plan.n_tiles * plan.tt * m
            per = plan.n_tiles // n_data
            blk = slice(d_idx * per, (d_idx + 1) * per)
            ids_c, cts_c, seg_c, doc_c = (
                torch.from_numpy(np.ascontiguousarray(a[:, blk])).to(dev)
                for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids))
            picks_rng = torch.from_numpy(picks).to(rng_dev)
            for j, pk in enumerate(packs):
                gamma0 = docs_gamma_to_tiles(
                    self._gamma_rows(run, it + j, picks_rng[j]), doc_c[j])
                lam = tiles_iteration(lam, it + j, ids_c[j], cts_c[j],
                                      seg_c[j], gamma0, pk[3], d=plan.d,
                                      **kw)
            return lam

        def flat_chunk(lam, it, picks, packs):
            """The token slots of each minibatch padded to a power of two,
            then to a multiple of the data shards (the JAX package's
            widths); pad slots carry weight 0."""
            m = len(packs)
            self.last_gamma_backend = "xla"
            t_pad = next_pow2(max(8, max(pk[0].size for pk in packs)))
            t_pad = -(-t_pad // n_data) * n_data
            cells[0] += t_pad * m
            tok = [np.zeros((m, t_pad), dt)
                   for dt in (np.int32, np.float32, np.int32)]
            for j, pk in enumerate(packs):
                for a, x in zip(tok, pk[:3]):
                    a[j, :x.size] = x
            t_l = t_pad // n_data
            ids_c, cts_c, seg_c = (
                torch.from_numpy(np.ascontiguousarray(
                    a[:, d_idx * t_l:(d_idx + 1) * t_l])).to(dev)
                for a in tok)
            picks_rng = torch.from_numpy(picks).to(rng_dev)
            for j, pk in enumerate(packs):
                lam = packed_iteration(
                    lam, it + j, ids_c[j], cts_c[j], seg_c[j],
                    self._gamma_rows(run, it + j, picks_rng[j]), pk[3], **kw)
            return lam

        def chunk(lam, it, m):
            nonlocal use_tiles
            picks = np.stack([run.make_pick(i) for i in range(it, it + m)])
            packs = [pack(pk) for pk in picks]
            self.last_layout = "packed"
            cells[1] += m
            plan = None
            if use_tiles:
                plan = plan_tile_pack_uniform(
                    [pk[:3] for pk in packs], b=picks.shape[1],
                    tile_tokens=tile_tt, n_tiles_multiple=n_data, k=k)
                # no tile geometry fits: the whole fit takes the flat loop
                use_tiles = plan is not None
            step = torch.tensor(it)
            if plan is not None:
                lam = _packed_tiles_run(lam, step, m, lambda lam: tiles_chunk(
                    lam, it, picks, packs, plan))
            else:
                lam = _packed_flat_run(lam, step, m, lambda lam: flat_chunk(
                    lam, it, picks, packs))
            self.last_batch_cells = cells[0] // cells[1]
            return lam

        est_cells = next_pow2(
            max(8, int(doc_lens.mean() * run.bsz)) if n else 8)
        interval = _dispatch_interval(p, run.ckpt_path, run.verbose,
                                      run.n_iters, 32 * est_cells)
        lam = self._chunked(run, interval, chunk, "packed")
        return self._model(run, lam, vocab)

    # ---- the padded paths --------------------------------------------
    def _resident_arrays(self, rows, n: int, row_len: int):
        """This data rank's rows of the padded corpus [N_pad, row_len]
        (N_pad: n rounded up to a multiple of the data shards, the rows
        past n empty) on the device, or None where ``device_resident`` is
        False, or "auto" and N_pad over ``resident_budget_bytes``."""
        p = self.params
        d_idx, n_data = self._data
        n_pad = -(-n // n_data) * n_data
        nbytes = n_pad * row_len * 8  # int32 ids + float32 weights
        if p.device_resident is not True and not (
            p.device_resident == "auto" and nbytes <= p.resident_budget_bytes
        ):
            return None
        per = n_pad // n_data
        empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
        block = list(rows[d_idx * per:(d_idx + 1) * per])
        batch = batch_from_rows(block + [empty] * (per - len(block)),
                                row_len=row_len, device=self.device)
        return batch.token_ids, batch.token_weights

    def _fit_padded_resident(self, rows, vocab, run: _Run, resident,
                             nonempty: np.ndarray):
        """The padded corpus resident on the device, each data rank its
        rows; each iteration assembles its picked rows (JAX's ownership
        gather: the rows a rank owns, zeros elsewhere, one ``psum_data``),
        and each rank runs the padded E-step kernel on its slice of them."""
        p = self.params
        n = run.n
        g = self.grid
        d_idx, n_data = self._data
        ids_res, wts_res = resident
        shard_n = ids_res.shape[0]
        b_s = run.bsz // n_data
        mine = slice(d_idx * b_s, (d_idx + 1) * b_s)
        dev, rng_dev = self.device, self.rng_device
        kw = dict(alpha=run.alpha_t, eta=run.eta, tau0=p.tau0,
                  kappa=p.kappa, corpus_size=float(n),
                  max_inner=p.estep_max_inner, tol=p.estep_tol, grid=g)
        self.last_gamma_backend = "pallas"

        def assemble(pick):
            local = pick.long() - d_idx * shard_n
            own = ((local >= 0) & (local < shard_n))[:, None]
            local = local.clamp(0, max(0, shard_n - 1))
            ids_b = torch.where(own, ids_res[local], 0)
            wts_b = torch.where(own, wts_res[local], 0.0)
            if g is not None:
                ids_b, wts_b = psum_data(g, ids_b), psum_data(g, wts_b)
            return ids_b[mine], wts_b[mine]

        def chunk(lam, it, m):
            picks = np.stack([run.make_pick(i) for i in range(it, it + m)])
            picks_rng = torch.from_numpy(picks[:, mine].copy()).to(rng_dev)
            picks_dev = torch.from_numpy(picks).to(dev)
            for j in range(m):
                # docs the M-step counts, the whole minibatch's
                docs = int(nonempty[np.minimum(picks[j], n)].sum())
                if docs:
                    ids_s, wts_s = assemble(picks_dev[j])
                    lam = padded_iteration(
                        lam, it + j, ids_s, wts_s,
                        self._gamma_rows(run, it + j, picks_rng[j]), docs,
                        **kw)
            return lam

        interval = _dispatch_interval(p, run.ckpt_path, run.verbose,
                                      run.n_iters)
        lam = self._chunked(run, interval, chunk, "padded-resident")
        return self._model(run, lam, vocab)

    def _fit_padded_host(self, rows, vocab, run: _Run, row_len: int,
                         nonempty: np.ndarray):
        """Each minibatch grouped into power-of-two length buckets on the
        host (one bucket of ``row_len`` where ``bucket_by_length`` is
        off), each bucket's doc axis padded to a power of two of at least
        the data shards and cut into one block a data rank; the buckets'
        statistics add up, then one ``psum_data`` and one M-step."""
        p = self.params
        n, dev, g = run.n, self.device, self.grid
        d_idx, n_data = self._data
        self.last_gamma_backend = "pallas"
        empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
        lam, timer = run.lam, run.timer
        self.last_dispatches = run.n_iters - run.start_it
        for it in range(run.start_it, run.n_iters):
            timer.start()
            pick = self.sample_pick(it)
            if pick.size:
                if p.bucket_by_length:
                    groups: dict = {}
                    for i in pick:
                        width = max(8, next_pow2(len(rows[i][0])))
                        groups.setdefault(width, []).append(int(i))
                else:
                    groups = {row_len: [int(i) for i in pick]}
                eb = _eb_run(lam, g)
                sstats = torch.zeros_like(lam)
                docs = 0
                for width, idxs in sorted(groups.items()):
                    b_pad = max(next_pow2(len(idxs)), n_data)
                    b_pad = -(-b_pad // n_data) * n_data
                    b_s = b_pad // n_data
                    mine = slice(d_idx * b_s, (d_idx + 1) * b_s)
                    padded = [rows[i] for i in idxs] + [empty] * (
                        b_pad - len(idxs))
                    doc_ids = idxs + list(range(n, n + b_pad - len(idxs)))
                    batch = batch_from_rows(padded[mine], row_len=width,
                                            device=dev)
                    sstats += _estep_run(
                        eb, batch.token_ids, batch.token_weights,
                        self._gamma_rows(run, it, torch.from_numpy(
                            np.asarray(doc_ids[mine], np.int64)).to(
                                self.rng_device)),
                        alpha=run.alpha_t, max_inner=p.estep_max_inner,
                        tol=p.estep_tol, grid=g)
                    docs += int(nonempty[idxs].sum())
                if g is not None:
                    sstats = psum_data(g, sstats)
                lam = _mstep_run(lam, eb, sstats, torch.tensor([it, docs]),
                                 eta=run.eta, tau0=p.tau0, kappa=p.kappa,
                                 corpus_size=float(n))
                self._sync(lam, "online_host")
            # an empty Bernoulli draw skips the update, not the checkpoint
            timer.stop()
            self._say(run, f"iter {it}: {timer.times[-1]:.4f}s (padded-host)")
            if run.ckpt_path and (it + 1) % p.checkpoint_interval == 0:
                self._save(run, it + 1, lam)
        return self._model(run, lam, vocab)

    # ------------------------------------------------------------------
    def fit(
        self,
        rows: Sequence[Tuple[np.ndarray, np.ndarray]],
        vocab: List[str],
        verbose: bool = False,
        max_iterations: Optional[int] = None,
    ) -> LDAModel:
        p = self.params
        if p.sampling not in ("fixed", "bernoulli", "epoch"):
            raise ValueError(f"unknown sampling {p.sampling!r} "
                             "(use 'fixed'|'bernoulli'|'epoch')")
        if p.token_layout not in ("padded", "packed", "tiles", "auto"):
            raise ValueError(f"unknown token_layout {p.token_layout!r} "
                             "(use 'padded'|'packed'|'tiles'|'auto')")
        if p.token_layout == "tiles" and p.sampling != "epoch":
            raise ValueError(
                "token_layout='tiles' requires sampling='epoch' (the "
                "tiled-resident path walks a block-stratified epoch "
                "stream over resident corpus tiles)"
            )
        dev, g = self.device, self.grid
        n_iters = p.max_iterations if max_iterations is None else max_iterations
        n, k, v = len(rows), p.k, len(vocab)
        alpha = np.full((k,), p.resolved_alpha(), np.float32)
        eta = p.resolved_eta()
        _, n_data = self._data
        shards = 1 if g is None else g.model_shards
        v_pad = -(-v // shards) * shards
        cols = slice(0, v_pad) if g is None else slice(
            g.m * (v_pad // shards), (g.m + 1) * (v_pad // shards))

        bsz, fraction = _online_batch_size(p, n)
        # the minibatch divides evenly over the data shards
        bsz = -(-bsz // n_data) * n_data
        self.last_batch_size = min(bsz, n)
        self.sample_pick = _sample_stream(p, n, bsz, fraction)
        lens = np.array([len(i) for i, _ in rows], np.int64)
        max_nnz = int(lens.max()) if n else 1
        row_len = max(8, next_pow2(max_nnz))
        mean_nnz = max(1.0, float(lens.sum()) / max(1, n))
        self.last_row_len = row_len
        self.last_layout = "padded"
        self.last_batch_cells = bsz * row_len

        ckpt_path = (os.path.join(p.checkpoint_dir, "train_state.npz")
                     if p.checkpoint_dir else None)
        start_it = 0
        if agree_checkpoint_exists(ckpt_path):
            st = load_train_state(ckpt_path, require=("lam",))
            if st["lam"].shape != (k, v_pad):
                raise ValueError(f"checkpoint lam {st['lam'].shape} != "
                                 f"expected {(k, v_pad)}")
            start_it = st["step"]
            lam = torch.as_tensor(np.ascontiguousarray(st["lam"][:, cols]),
                                  dtype=torch.float32).to(dev)
        else:
            # one draw of the whole [k, V_pad] table on every rank
            lam = init_lambda(
                seeded_generator(self.rng_device, p.seed, _LAMBDA_KEY),
                k, v_pad, p.gamma_shape, device=dev)[:, cols].contiguous()

        def make_pick(it: int) -> np.ndarray:
            """``sample_pick`` padded to bsz with the inert ids n, n+1..."""
            pick = self.sample_pick(it)
            return np.concatenate(
                [pick, np.arange(n, n + bsz - pick.size, dtype=np.int32)])

        run = _Run(n=n, k=k, v=v, bsz=bsz, n_iters=n_iters,
                   start_it=start_it, alpha=alpha,
                   alpha_t=torch.from_numpy(alpha).to(dev), eta=eta, lam=lam,
                   ckpt_path=ckpt_path, verbose=verbose, timer=IterationTimer(),
                   make_pick=make_pick)

        waste = row_len >= 4.0 * mean_nnz
        if p.sampling == "epoch" and p.device_resident is not False and (
            p.token_layout == "tiles"
            or (p.token_layout == "auto" and waste)
        ):
            model = self._fit_tiles_resident(
                rows, vocab, run, forced=p.token_layout == "tiles")
            if model is not None:
                return model
        # an explicit device_resident=True wins over the auto layout, an
        # explicit "packed" over everything
        if p.token_layout in ("packed", "tiles") or (
            p.token_layout == "auto" and p.device_resident is not True
            and waste
        ):
            return self._fit_packed(rows, vocab, run)
        # docs the M-step counts: (wts.sum(-1) > 0), and pad picks none
        nonempty = np.zeros(n + 1, bool)
        nonempty[:n] = [float(np.sum(w, dtype=np.float32)) > 0
                        for _, w in rows]
        resident = self._resident_arrays(rows, n, row_len)
        if resident is not None:
            return self._fit_padded_resident(rows, vocab, run, resident,
                                             nonempty)
        return self._fit_padded_host(rows, vocab, run, row_len, nonempty)
