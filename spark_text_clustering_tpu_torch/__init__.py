"""PyTorch/CUDA port of spark_text_clustering_tpu for an NVIDIA H100.

Imports ``torch``, never ``jax``, and nothing of the JAX package.  Entry
points take ``device=`` and default to ``"cuda"``; pass ``device="cpu"``
to run the plain PyTorch versions of the kernels on the host.  The
command line is ``python -m spark_text_clustering_tpu_torch.cli
train|score`` (``--device cpu`` for the host).
"""

from .config import Params
from .models.base import LDAModel
from .models.em_lda import EMLDA
from .models.nmf import NMF, NMFModel
from .models.online_lda import OnlineLDA
from .models.persistence import load_model
from .pipeline import IDF, LDA, CountVectorizer, NMFEstimator

__all__ = ["CountVectorizer", "EMLDA", "IDF", "LDA", "LDAModel", "NMF",
           "NMFEstimator", "NMFModel", "OnlineLDA", "Params", "load_model"]
