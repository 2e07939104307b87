"""Hyperparameters and run configuration: the fields of the reference's
``Params`` case class and of the JAX package's ``Params``, every one with
the same name, position and default (a positional call binds the same
fields in both packages), and the EM/online auto priors.  Kept as its own
copy so the port imports nothing of the JAX package.

``to_json`` emits every field as the JAX package does, so the resume gate's
``config_hash`` (``resilience/resume.py``) is the same in both packages for
the same flags, and a checkpoint dir that either CLI wrote is accepted by
the other."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

__all__ = ["Params"]


@dataclass
class Params:
    """LDA training hyperparameters.  ``-1`` concentrations mean "auto":
    EM alpha = 50/k + 1, eta = 1.1; online alpha = eta = 1/k."""

    input: str = ""
    k: int = 5
    max_iterations: int = 50
    doc_concentration: float = -1.0
    topic_concentration: float = -1.0
    vocab_size: int = 2_900_000
    stop_word_text: Optional[str] = None
    algorithm: str = "em"
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 10
    # online VB (MLlib's OnlineLDAOptimizer constants; batch_size None ->
    # mini_batch_fraction of the corpus per iteration)
    tau0: float = 1024.0
    kappa: float = 0.51
    gamma_shape: float = 100.0
    batch_size: Optional[int] = None
    sampling: str = "bernoulli"        # "bernoulli" | "fixed" | "epoch"
    seed: int = 0
    # IDF (MLlib minDocFreq, and the reference's floor for a zero idf)
    min_doc_freq: int = 2
    idf_floor: float = 0.0001
    data_shards: Optional[int] = None
    model_shards: int = 1
    bucket_by_length: object = "auto"  # True | False | "auto"
    device_resident: object = "auto"   # True | False | "auto"
    resident_budget_bytes: int = 2 << 30
    token_layout: str = "auto"         # "padded" | "packed" | "tiles" | "auto"
    record_iteration_times: bool = False
    estep_max_inner: int = 100
    estep_tol: float = 1e-3
    dispatch_budget_bytes: int = 256 << 20
    keep_doc_topic_counts: bool = False

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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
