"""cvmatrix_tpu — fast cross-validation matrix engine in JAX.

A from-scratch JAX/XLA implementation of the Engstrøm–Jensen fast
cross-validation algorithms (the capability set of the reference
``sm00thix/cvmatrix``, v3.2.1): compute the global weighted products
``X^T W X`` / ``X^T W Y`` once, then derive each fold's training-set matrices
by downdating the validation block with rank-one weighted centering/scaling
corrections — never re-materialising a preprocessed copy of ``X`` per fold.

Public surface (reference parity: ``cvmatrix/__init__.py:1-4``):
``CVMatrix`` (the engine facade) and ``Partitioner`` (fold bookkeeping),
plus the functional core (``CVConfig``, ``FitState``, ``fit``,
``training_*``) for jit/vmap/mesh-sharded use.
"""

from .config import CVConfig
from .core import (
    FitState,
    fit,
    training_matrices,
    training_statistics,
    training_XTX,
    training_XTX_XTY,
    training_XTY,
)
from .models import CVMatrix, Partitioner

__version__ = "0.6.0"

__all__ = [
    "CVMatrix",
    "Partitioner",
    "CVConfig",
    "FitState",
    "fit",
    "training_matrices",
    "training_XTX",
    "training_XTY",
    "training_XTX_XTY",
    "training_statistics",
    "__version__",
]
