"""Hyperparameters of the port's EM and online-VB fits: the fields of the
reference's ``Params`` case class and of the JAX package's ``Params`` that
the port reads, with the same defaults and the EM/online auto priors.
Kept as its own copy so the port imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

__all__ = ["Params"]


@dataclass
class Params:
    """LDA training hyperparameters.  ``-1`` concentrations mean "auto":
    EM alpha = 50/k + 1, eta = 1.1; online alpha = eta = 1/k."""

    k: int = 5
    max_iterations: int = 50
    doc_concentration: float = -1.0
    topic_concentration: float = -1.0
    algorithm: str = "em"
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 10
    gamma_shape: float = 100.0
    seed: int = 0
    data_shards: Optional[int] = None
    model_shards: int = 1
    record_iteration_times: bool = False
    keep_doc_topic_counts: bool = False
    # online VB (MLlib's OnlineLDAOptimizer constants; batch_size None ->
    # mini_batch_fraction of the corpus per iteration)
    tau0: float = 1024.0
    kappa: float = 0.51
    batch_size: Optional[int] = None
    sampling: str = "bernoulli"        # "bernoulli" | "fixed" | "epoch"
    token_layout: str = "auto"         # "padded" | "packed" | "tiles" | "auto"
    device_resident: object = "auto"   # True | False | "auto"
    resident_budget_bytes: int = 2 << 30
    estep_max_inner: int = 100
    estep_tol: float = 1e-3

    def resolved_alpha(self) -> float:
        if self.doc_concentration > 0:
            return float(self.doc_concentration)
        if self.algorithm == "em":
            return 50.0 / self.k + 1.0
        return 1.0 / self.k

    def resolved_eta(self) -> float:
        if self.topic_concentration > 0:
            return float(self.topic_concentration)
        if self.algorithm == "em":
            return 1.1
        return 1.0 / self.k

    def mini_batch_fraction(self, corpus_size: int) -> float:
        """MLlib's ``miniBatchFraction = 0.05 + 1/corpusSize``."""
        return 0.05 + 1.0 / max(1, corpus_size)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
