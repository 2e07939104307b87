"""Online variational-Bayes LDA on one device: MLlib's
``OnlineLDAOptimizer`` over the device-resident tiled corpus (the JAX
package's ``token_layout="tiles"`` path).

The corpus is tiled once, in doc order (``ops.packed.plan_corpus_tiles``),
and stays on the device.  Each iteration draws a block-stratified epoch
minibatch of whole tiles (every doc once per epoch; docs packed into one
tile are drawn together), then:

    eb     = exp(E[log beta]) at the minibatch's tokens           [k, T]
    gamma  = the tile gamma fixed point (``gamma_fixed_point_tiles``:
             the CUDA kernel on the card, its plain version on the CPU)
    sstats = sum over tokens of exp(E[log theta]) * cts / phinorm * eb,
             scattered into [k, V]
    lambda <- (1 - rho) lambda + rho (eta + D / |B| sstats),
             rho = (tau0 + t + 1)^-kappa; skipped for an empty minibatch

Random draws come from explicit ``torch.Generator``s on ``rng_device``
(the fit's device unless asked otherwise): lambda from one seeded by
(seed, 0xFFFF), and each iteration's gamma inits from one Gamma table
[n+1, k] seeded by (seed, 0x6A33, step) and indexed by each slot's
global doc id (pad slots read row n), so a doc's init depends on (seed,
step, doc) only.
A fit resumes from ``<checkpoint_dir>/train_state.npz`` (lam [k, V],
step): the JAX package's checkpoint.

Only this path is ported: other sampling modes, the padded and
host-streaming packed layouts, and sharding raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..ops.lda_math import init_gamma, init_lambda, seeded_generator
from ..ops.packed import gamma_fixed_point_tiles, plan_corpus_tiles
from ..ops.sparse import next_pow2
from ..utils.timing import IterationTimer
from .base import LDAModel
from .persistence import load_train_state, save_train_state, train_state_valid

__all__ = ["OnlineLDA", "tiles_iteration"]

_PHI_EPS = 1e-30
_LAMBDA_KEY = 0xFFFF     # lambda's generator: (seed, 0xFFFF)
_GAMMA_KEY = 0x6A33      # step t's gamma inits: (seed, 0x6A33, t)
_TILE_EPOCH_KEY = 0x71E5  # the tile sampler's numpy stream, as in JAX


def tiles_iteration(
    lam: torch.Tensor,           # [k, V]
    step: int,
    ids_t: torch.Tensor,         # [tb, tt] int32 token ids of the picked tiles
    cts_t: torch.Tensor,         # [tb, tt] float32
    seg_t: torch.Tensor,         # [tb, tt] int32 tile-local doc slots
    gamma0: torch.Tensor,        # [k, tb * d] gamma inits in slot order
    batch_docs: int,             # real docs in the picked tiles
    *,
    alpha: torch.Tensor,
    eta: float,
    tau0: float,
    kappa: float,
    d: int,
    corpus_size: float,
    max_inner: int = 100,
    tol: float = 1e-3,
) -> torch.Tensor:
    """One online-VB update from a minibatch of tiles; returns the new
    lambda (the input is not modified).  The steps follow the JAX
    package's tiles-resident iteration; only the gamma fixed point is a
    kernel, the rest is plain torch, as JAX leaves it to XLA."""
    if batch_docs <= 0:
        return lam                     # MLlib skips an empty minibatch
    tb = ids_t.shape[0]
    flat = ids_t.reshape(-1).long()
    row_sum = lam.sum(dim=1)                                   # [k]
    lam_tok = lam[:, flat]                                     # [k, T]
    eb_kt = torch.exp(
        torch.digamma(lam_tok.clamp(min=1e-30))
        - torch.digamma(row_sum)[:, None]
    )
    gamma_tiles = gamma_fixed_point_tiles(
        eb_kt, cts_t, seg_t, alpha, gamma0, d, max_inner, tol
    )                                                          # [k, tb*d]
    exp_et = torch.exp(
        torch.digamma(gamma_tiles)
        - torch.digamma(gamma_tiles.sum(dim=0, keepdim=True))
    )
    tile = torch.arange(tb, device=seg_t.device)[:, None]
    slot = (tile * d + seg_t.clamp(max=d - 1)).reshape(-1)     # [T]
    et_tok = exp_et[:, slot]
    # pad token slots carry cts == 0 and contribute nothing
    phinorm = (eb_kt * et_tok).sum(dim=0) + _PHI_EPS
    vals = et_tok * (cts_t.reshape(-1) / phinorm)[None, :] * eb_kt
    touched = torch.zeros_like(lam).index_add_(1, flat, vals)
    # rho_t = (tau0 + t + 1)^-kappa and the blend, in float32 as in JAX
    rho = np.float32(
        (np.float32(tau0) + np.float32(step) + np.float32(1.0))
        ** np.float32(-kappa))
    scale = np.float32(corpus_size) / np.float32(max(batch_docs, 1))
    lam_new = lam * float(np.float32(1.0) - rho) + float(rho * np.float32(eta))
    return lam_new.add_(touched, alpha=float(rho * scale))


class OnlineLDA:
    """Estimator for the online path: ``fit(rows, vocab) -> LDAModel``
    with the online auto priors alpha = eta = 1/k."""

    def __init__(self, params: Params, device="cuda", rng_device=None) -> None:
        if params.algorithm != "online":
            params = params.replace(algorithm="online")
        if params.model_shards != 1 or params.data_shards not in (None, 1):
            raise NotImplementedError(
                "data_shards/model_shards > 1 are not ported: the port's "
                "online fit runs on one device"
            )
        self.params = params
        self.device = resolve_device(device)
        self.rng_device = (
            self.device if rng_device is None else resolve_device(rng_device)
        )
        self.last_batch_size: Optional[int] = None
        self.last_layout = "none"
        self.last_tiles: Optional[dict] = None
        self._corpus_cache = None

    # ------------------------------------------------------------------
    def _batch_size(self, n: int) -> int:
        """Docs an iteration: ``batch_size``, else MLlib's fraction of
        the corpus (clamped to 1 for a tiny corpus)."""
        p = self.params
        if p.batch_size is not None:
            return min(p.batch_size, n)
        fraction = min(1.0, p.mini_batch_fraction(n))
        return max(1, min(n, round(fraction * n)))

    def _check_path(self, rows) -> None:
        """Raise for every configuration whose path is not ported."""
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
        if p.sampling != "epoch":
            raise NotImplementedError(
                f"sampling={p.sampling!r} is not ported: the port trains "
                "sampling='epoch' on the tiles-resident path"
            )
        if p.token_layout in ("padded", "packed"):
            raise NotImplementedError(
                f"token_layout={p.token_layout!r} (the padded and "
                "host-streaming packed online paths) is not ported; use "
                "'tiles' or 'auto'"
            )
        if p.device_resident is False:
            raise NotImplementedError(
                "device_resident=False selects the host-streaming online "
                "path, which is not ported"
            )
        if p.token_layout == "auto":
            n = len(rows)
            max_nnz = max((len(i) for i, _ in rows), default=1)
            mean_nnz = max(1.0, sum(len(i) for i, _ in rows) / max(1, n))
            if max(8, next_pow2(max_nnz)) < 4.0 * mean_nnz:
                raise NotImplementedError(
                    "token_layout='auto' takes the padded online path for "
                    "this corpus (padding waste < 4x), which is not "
                    "ported; pass token_layout='tiles'"
                )

    def _plan(self, rows, n: int, k: int):
        """The corpus plan, its real tiles and the resident tensors,
        cached across fits of the same corpus (keyed by content: doc
        count, token total, and three sample rows)."""
        p = self.params
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
        fp = hashlib.blake2b(digest_size=16)
        fp.update(np.int64(n).tobytes())
        fp.update(offsets[-1:].tobytes())
        for i in ((0, n // 2, n - 1) if n else ()):
            fp.update(np.asarray(rows[i][0], np.int32).tobytes())
            fp.update(np.asarray(rows[i][1], np.float32).tobytes())
        key = (fp.hexdigest(), n, int(offsets[-1]), k, str(self.device),
               str(self.rng_device))
        if self._corpus_cache is not None and self._corpus_cache[0] == key:
            return self._corpus_cache[1]
        flat_ids = (np.concatenate([np.asarray(i, np.int32) for i, _ in rows])
                    if rows else np.zeros(0, np.int32))
        flat_cts = (np.concatenate([np.asarray(w, np.float32) for _, w in rows])
                    if rows else np.zeros(0, np.float32))
        plan = plan_corpus_tiles(flat_ids, flat_cts, offsets, n_shards=1, k=k)
        if plan is None:
            raise NotImplementedError(
                "no tile geometry fits this corpus (a document wider than "
                "the tile budget); the host-streaming packed path it needs "
                "is not ported"
            )
        resident_bytes = (plan.ids.nbytes + plan.cts.nbytes
                          + plan.seg.nbytes + plan.doc_ids.nbytes)
        if resident_bytes > p.resident_budget_bytes:
            raise NotImplementedError(
                f"the tiled corpus ({resident_bytes} bytes) exceeds "
                f"resident_budget_bytes={p.resident_budget_bytes}; the "
                "host-streaming packed path it needs is not ported"
            )
        n_real = int((plan.doc_ids[:, 0] < n).sum())
        if n_real == 0:
            raise ValueError("the corpus has no documents")
        dev = self.device
        resident = tuple(
            torch.from_numpy(a).to(dev)
            for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids)
        )
        doc_rng = resident[3].to(self.rng_device)
        out = (plan, n_real, resident, doc_rng, resident_bytes)
        self._corpus_cache = (key, out)
        return out

    # ------------------------------------------------------------------
    def fit(
        self,
        rows: Sequence[Tuple[np.ndarray, np.ndarray]],
        vocab: List[str],
        verbose: bool = False,
        max_iterations: Optional[int] = None,
    ) -> LDAModel:
        p = self.params
        dev, rng_dev = self.device, self.rng_device
        n_iters = p.max_iterations if max_iterations is None else max_iterations
        n, k, v = len(rows), p.k, len(vocab)
        alpha = np.full((k,), p.resolved_alpha(), np.float32)
        eta = p.resolved_eta()
        self._check_path(rows)
        bsz = self._batch_size(n)

        ckpt_path = (os.path.join(p.checkpoint_dir, "train_state.npz")
                     if p.checkpoint_dir else None)
        start_it = 0
        if ckpt_path and train_state_valid(ckpt_path):
            st = load_train_state(ckpt_path, require=("lam",))
            if st["lam"].shape != (k, v):
                raise ValueError(
                    f"checkpoint lam {st['lam'].shape} != expected {(k, v)}")
            start_it = st["step"]
            lam = torch.as_tensor(st["lam"], dtype=torch.float32).to(dev)
        else:
            lam = init_lambda(seeded_generator(rng_dev, p.seed, _LAMBDA_KEY),
                              k, v, p.gamma_shape, device=dev)

        plan, n_real, resident, doc_rng, resident_bytes = self._plan(rows, n, k)
        ids_res, cts_res, seg_res, _ = resident
        # tiles per iteration: the doc-level batch fraction in tiles
        tb_target = round(bsz / max(1, n) * n_real)
        if p.token_layout == "auto" and tb_target < 2:
            raise NotImplementedError(
                "token_layout='auto' leaves the tiles path when the batch "
                f"fraction maps to {tb_target} tile(s) an iteration (< 2); "
                "the host-streaming packed path it takes is not ported; "
                "pass token_layout='tiles'"
            )
        tb_l = max(1, tb_target)

        # block-stratified epoch stream over the real tiles, pure in
        # (seed, it): the JAX package's stream for its one data shard
        perms: dict = {}

        def _perm(epoch: int) -> np.ndarray:
            if epoch not in perms:
                if len(perms) > 2:
                    perms.clear()
                perms[epoch] = np.random.default_rng(
                    (p.seed, _TILE_EPOCH_KEY, 0, epoch)
                ).permutation(n_real).astype(np.int32)
            return perms[epoch]

        def tile_pick(it: int) -> np.ndarray:
            out = np.empty((1, tb_l), np.int32)
            filled = 0
            start = it * tb_l
            while filled < tb_l:
                epoch, off = divmod(start + filled, n_real)
                take = min(tb_l - filled, n_real - off)
                out[0, filled:filled + take] = _perm(epoch)[off:off + take]
                filled += take
            return out

        self.tile_pick = tile_pick
        self.last_batch_size = int(round(n * tb_l / n_real))
        self.last_layout = "tiles_resident"
        self.last_tiles = {
            "n_tiles": int(plan.ids.shape[0]), "tt": plan.tt, "d": plan.d,
            "tiles_per_iter": tb_l, "reals_per_shard": [n_real],
            "resident_bytes": resident_bytes,
        }
        alpha_t = torch.from_numpy(alpha).to(dev)

        def iteration(lam, it: int, pick_np, pick, pick_rng):
            batch_docs = int((plan.doc_ids[pick_np] < n).sum())
            # this step's Gamma table [n+1, k], read at each slot's doc id
            gen = seeded_generator(rng_dev, p.seed, _GAMMA_KEY, it)
            table = init_gamma(gen, n + 1, k, p.gamma_shape, device=rng_dev)
            gamma0 = table[doc_rng[pick_rng].reshape(-1).long()].T
            return tiles_iteration(
                lam, it, ids_res[pick], cts_res[pick], seg_res[pick],
                gamma0.contiguous().to(dev), batch_docs, alpha=alpha_t,
                eta=eta, tau0=p.tau0, kappa=p.kappa, d=plan.d,
                corpus_size=float(n), max_inner=p.estep_max_inner,
                tol=p.estep_tol,
            )

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        per_iter = verbose or p.record_iteration_times
        interval = 1 if per_iter else (
            max(1, p.checkpoint_interval) if ckpt_path else max(1, n_iters))
        timer = IterationTimer()
        it = start_it
        while it < n_iters:
            m = min(interval - (it % interval), n_iters - it)
            timer.start()
            # the chunk's picks go to the device in one copy: a copy per
            # iteration would wait for the card every iteration
            picks = np.stack([tile_pick(i)[0] for i in range(it, it + m)])
            picks_dev = torch.from_numpy(picks).to(dev)
            picks_rng = picks_dev.to(rng_dev)
            for j in range(m):
                lam = iteration(lam, it + j, picks[j], picks_dev[j],
                                picks_rng[j])
            sync()
            timer.stop()
            timer.split_last(m)
            if verbose:
                print(f"iter {it}: {timer.times[-1]:.4f}s (tiles-resident)")
            it += m
            if ckpt_path and it % max(1, p.checkpoint_interval) == 0:
                save_train_state(ckpt_path, it, lam=lam.cpu().numpy())
        return LDAModel(
            lam=lam.cpu().numpy(),
            vocab=list(vocab),
            alpha=alpha,
            eta=float(eta),
            gamma_shape=p.gamma_shape,
            iteration_times=list(timer.times),
            iteration_times_kind=timer.kind,
            algorithm="online",
            step=start_it + len(timer.times),
            device=str(dev),
        )
