"""What each rank of a CPU grid runs for ``test_torch_sharding_online.py``
(not a test file).  The ranks are spawned processes: this module imports
torch, numpy and the port only, never jax.

``suite(grid, spec)`` runs every online-VB and NMF check of one grid shape
in one spawn and returns its results as numpy arrays and plain values;
the test file holds them against the JAX package on a mesh of the same
shape and against the port's one-device fits.
"""

from __future__ import annotations

import torch

from spark_text_clustering_tpu_torch import NMF, OnlineLDA, Params
from spark_text_clustering_tpu_torch.interop import nmf_init_from_numpy
from spark_text_clustering_tpu_torch.models import nmf as nmf_module

DECISIONS = ("last_layout", "last_row_len", "last_batch_size",
             "last_gamma_backend", "last_batch_cells", "last_tiles")


class JaxInits(OnlineLDA):
    """``OnlineLDA`` fed the JAX package's gamma inits: ``g0[step]`` holds
    ``init_gamma_rows`` of every doc id a fit can pick (pads included)."""

    def __init__(self, *args, g0=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.g0 = g0

    def _gamma_rows(self, run, step, ids):
        return torch.from_numpy(self.g0[step][ids.cpu().numpy()])


def online_fit(grid, rows, v, kw, rule=None, g0=None, iters=None,
               picks=0) -> dict:
    """One online fit on ``grid``: lambda, step, the decisions, and the
    first ``picks`` iterations' tile picks (tiles-resident) or doc picks."""
    params = Params(algorithm="online", **kw)
    opt = (OnlineLDA(params, device="cpu", rule=rule, grid=grid)
           if g0 is None else
           JaxInits(params, device="cpu", rule=rule, grid=grid, g0=g0))
    model = opt.fit(rows, [f"t{i}" for i in range(v)], max_iterations=iters)
    out = {"lam": model.lam, "step": model.step,
           "decisions": {name: getattr(opt, name) for name in DECISIONS}}
    if opt.last_layout == "tiles_resident":
        out["picks"] = [opt.tile_pick(i) for i in range(picks)]
    else:
        out["picks"] = [opt.sample_pick(i) for i in range(picks)]
    return out


def nmf_fit(grid, rows, v, kw, init=None, flat=False) -> tuple:
    """One NMF fit on ``grid`` (from ``init`` = (w0, h0) or the seed);
    ``flat`` takes the flat packed layout, as where no tile geometry
    fits.  Returns (h, loss, layout, backend)."""
    opt = NMF(Params(**kw), device="cpu", grid=grid)
    plan = nmf_module.plan_corpus_tiles
    if flat:
        nmf_module.plan_corpus_tiles = lambda *a, **k: None
    try:
        model = opt.fit(rows, [f"t{i}" for i in range(v)],
                        init=None if init is None
                        else nmf_init_from_numpy(*init))
    finally:
        nmf_module.plan_corpus_tiles = plan
    return model.h, model.loss, opt.last_layout, opt.last_mu_backend


def suite(grid, spec) -> dict:
    """Every check of one grid shape (see the test file)."""
    torch.set_num_threads(1)
    out = {"rank": grid.rank}
    shape = (grid.data_shards, grid.model_shards)
    out["online"] = {
        name: online_fit(grid, spec["corpora"][c["corpus"]], spec["v"],
                         c["kw"], rule=c["rule"], g0=spec["g0"][c["corpus"]],
                         picks=4)
        for name, c in spec["online"].items() if shape in c["shapes"]}
    out["nmf"] = {
        name: nmf_fit(grid, spec["corpora"][c["corpus"]], spec["v"], c["kw"],
                      init=spec["nmf_init"][c["corpus"]], flat=c["flat"])
        for name, c in spec["nmf"].items()}
    if grid.size == 4:
        out.update(suite_2x2(grid, spec))
    return out


def suite_2x2(grid, spec) -> dict:
    """The checks of the 2x2 grid only: fits from a seed, and checkpoints
    written on the grid and resumed there."""
    out = {}
    v = spec["v"]
    for name, c in spec["seed"].items():
        rows = spec["corpora"][c["corpus"]]
        if c["nmf"]:
            out[f"seed_{name}"] = nmf_fit(grid, rows, v, c["kw"],
                                          flat=c.get("flat", False))
        else:
            out[f"seed_{name}"] = online_fit(grid, rows, v, c["kw"],
                                             rule=c["rule"])
    # train_state.npz written at 2x2 for 1x1 resumes in both packages; the
    # odd-V corpus's is resumed again here, on the grid
    for name, (rows, v_c) in spec["ckpt_rows"].items():
        kw = dict(spec["ckpt_kw"], checkpoint_dir=spec["ckpt_out"][name])
        out[f"ckpt_{name}"] = online_fit(grid, rows, v_c, kw, rule="cpu",
                                         iters=2)
        # interval 100: the resume to step 4 writes no checkpoint
        out[f"ckpt_{name}_resumed"] = online_fit(
            grid, rows, v_c, dict(kw, checkpoint_interval=100), rule="cpu",
            iters=4)
    return out
