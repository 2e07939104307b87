"""What each rank of a CPU grid runs for ``test_torch_stream_grid.py`` (not
a test file).  The ranks are spawned processes: this module imports torch,
numpy and the port only, never jax.

``suite(grid, spec)`` runs every streaming-trainer check of one grid shape
in one spawn and returns, per check, lambda [k, V_pad] as every rank
fetched it and the trainer's counters; the test file holds them against
the JAX package's trainer on a mesh of the same shape and against the
port's one-device trainer.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from spark_text_clustering_tpu_torch import Params
from spark_text_clustering_tpu_torch import pipeline
from spark_text_clustering_tpu_torch.streaming import StreamingOnlineLDA


def python_text() -> None:
    """The Python (nltk) text path, as the JAX package's tests take it."""
    pipeline.TextPreprocessor._resolve_backend = lambda self: "python"


def trainer(grid, spec, v, checkpoint_dir=None, **kw) -> StreamingOnlineLDA:
    """A grid trainer of the spec's widths over ``v`` hash buckets."""
    return StreamingOnlineLDA(
        Params(k=spec["k"], seed=spec["seed"], checkpoint_dir=checkpoint_dir,
               data_shards=grid.data_shards, model_shards=grid.model_shards),
        num_features=v, batch_capacity=spec["capacity"],
        checkpoint_every=spec["checkpoint_every"], device="cpu", grid=grid,
        **kw)


def state(t: StreamingOnlineLDA) -> dict:
    """lambda [k, V_pad] (fetched over the vocabulary shards), the model's
    [k, V] and the counters."""
    return {"lam": t._host_lam(), "model_lam": t.model().lam,
            "step": t.step, "docs_seen": t.docs_seen,
            "batches_seen": t.batches_seen}


def suite(grid, spec) -> dict:
    """Every check of one grid shape (see the test file)."""
    torch.set_num_threads(1)
    python_text()
    shape = (grid.data_shards, grid.model_shards)
    batches = spec["batches"] if grid.rank == 0 else None
    out = {"rank": grid.rank, "jax_draws": {}}
    for name, case in spec["cases"].items():
        if shape not in case["shapes"]:
            continue
        g0 = case["g0"]
        t = trainer(grid, spec, case["v"],
                    checkpoint_dir=case["written"].get(shape),
                    init_lam=case["lam0"][shape[1]],
                    gamma0_fn=lambda step, n: g0[step][:n])
        t.run(batches)
        out["jax_draws"][name] = state(t)
    if shape == (2, 2):
        # from the seed, through process() in lockstep
        t = trainer(grid, spec, spec["v"])
        for mb in spec["batches"]:
            t.process(mb if grid.rank == 0 else None)
        out["seeded"] = state(t)
        # a dir the JAX package wrote on a (2, 2) mesh
        t = trainer(grid, spec, spec["v"], checkpoint_dir=spec["jax_dir"])
        out["resumed"] = {"lam": t._host_lam(), "step": t.step,
                          "docs_seen": t.docs_seen,
                          "batches_seen": t.batches_seen}
    return out


def wait_forever(grid, pid_dir) -> None:
    """Write this rank's pid under ``pid_dir``, then block: a rank whose
    parent is killed must end all the same."""
    with open(os.path.join(pid_dir, f"rank{grid.rank}"), "w") as f:
        f.write(str(os.getpid()))
    while True:
        time.sleep(1.0)


def loaded_jax(grid, spec) -> list:
    """Train the spec's micro-batches on this rank, then name every module
    of jax or the JAX package this process loaded (none should be)."""
    python_text()
    t = trainer(grid, spec, spec["v"])
    t.run(spec["batches"] if grid.rank == 0 else None)
    t.model()
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "spark_text_clustering_tpu"))
