"""Carrying weights across from numpy (and so from the JAX package).

``lda_model_from_numpy`` builds the port's ``LDAModel`` from arrays;
``em_state_from_numpy`` writes an ``em_state.npz`` checkpoint that
``EMLDA.fit`` resumes from, ``online_state_from_numpy`` a
``train_state.npz`` that ``OnlineLDA.fit`` resumes from (the file the JAX
package's online fit writes, so a JAX lambda carries over either way).
``nmf_model_from_numpy`` builds an ``NMFModel`` from H; ``nmf_init_from_numpy``
carries initial factors (the JAX package's draws, say) into ``NMF.fit(...,
init=...)``.  A model dir the JAX package saved needs none of these:
``models.persistence.load_model`` reads it directly.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .models.base import LDAModel
from .models.nmf import NMFInit, NMFModel
from .models.persistence import save_train_state

__all__ = ["em_state_from_numpy", "lda_model_from_numpy",
           "nmf_init_from_numpy", "nmf_model_from_numpy",
           "online_state_from_numpy"]


def lda_model_from_numpy(
    lam: np.ndarray,
    alpha,
    eta: float,
    vocab: Sequence[str],
    gamma_shape: float = 100.0,
    algorithm: str = "em",
    step: int = 0,
    device="cuda",
) -> LDAModel:
    """An ``LDAModel`` from a [k, V] pseudo-count table and its priors."""
    lam = np.asarray(lam, np.float32)
    if lam.ndim != 2 or lam.shape[1] != len(vocab):
        raise ValueError(f"lam {lam.shape} does not match {len(vocab)} terms")
    return LDAModel(
        lam=lam,
        vocab=list(vocab),
        alpha=np.broadcast_to(np.asarray(alpha, np.float32), (lam.shape[0],)).copy(),
        eta=float(eta),
        gamma_shape=gamma_shape,
        algorithm=algorithm,
        step=step,
        device=device,
    )


def em_state_from_numpy(
    checkpoint_dir: str, n_wk: np.ndarray, n_dk: np.ndarray, step: int = 0
) -> str:
    """Write ``<checkpoint_dir>/em_state.npz`` (n_wk [k, V], n_dk [n, k] in
    corpus order); returns its path."""
    path = os.path.join(checkpoint_dir, "em_state.npz")
    save_train_state(path, step, n_wk=n_wk, n_dk=n_dk)
    return path


def online_state_from_numpy(
    checkpoint_dir: str, lam: np.ndarray, step: int = 0
) -> str:
    """Write ``<checkpoint_dir>/train_state.npz`` (lam [k, V], step);
    returns its path."""
    path = os.path.join(checkpoint_dir, "train_state.npz")
    save_train_state(path, step, lam=lam)
    return path


def nmf_model_from_numpy(
    h: np.ndarray,
    vocab: Sequence[str],
    loss: float = float("nan"),
    step: int = 0,
    device="cuda",
) -> NMFModel:
    """An ``NMFModel`` from a [k, V] topic-term factor."""
    h = np.asarray(h, np.float32)
    if h.ndim != 2 or h.shape[1] != len(vocab):
        raise ValueError(f"h {h.shape} does not match {len(vocab)} terms")
    return NMFModel(h=h, vocab=list(vocab), loss=float(loss), step=step,
                    device=device)


def nmf_init_from_numpy(w0: np.ndarray, h0: np.ndarray) -> NMFInit:
    """Initial factors for ``NMF.fit(..., init=...)``: w0 [n, k] in the
    order of the rows the fit gets, h0 [k, V]."""
    w0 = np.ascontiguousarray(w0, np.float32)
    h0 = np.ascontiguousarray(h0, np.float32)
    if w0.ndim != 2 or h0.ndim != 2 or w0.shape[1] != h0.shape[0]:
        raise ValueError(f"w0 {w0.shape} and h0 {h0.shape} do not agree on k")
    return NMFInit(w0, h0)
