"""The immutable fitted state of the cross-validation engine.

The reference keeps its fitted globals as mutable instance attributes on
``CVMatrix`` (``cvmatrix/cvmatrix.py:188-205``). Here they form a frozen
dataclass registered as a JAX pytree, so the whole fitted state can be closed
over by / passed through ``jax.jit``, ``jax.vmap`` and sharded over a device
mesh without any host round-trips.

Conditional fields mirror the reference's conditional computation (only the
statistics the 16 center/scale combinations actually need are materialised,
``cvmatrix/cvmatrix.py:1219-1243``); absent statistics are ``None`` (empty
pytree subtrees).

Deviation: the reference materialises the weighted squared
matrices ``sq_X = WX * X`` and ``sq_Y = WY * Y`` (N x K / N x M) so it can
gather their validation rows per fold (``cvmatrix/cvmatrix.py:727,737,
1235,1240``). We do not: the per-fold code recomputes squared rows from the
already-gathered ``WX[v]`` and ``X[v]`` rows (elementwise product commutes
with gather, so results are bit-identical) — saving O(N(K+M)) HBM and one
gather stream per fold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

__all__ = ["FitState"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FitState:
    """Fitted dataset-wide arrays and statistics.

    Shapes: ``X (N, K)``, ``Y (N, M)``, ``weights (N, 1)``,
    ``XTX (K, K)``, ``XTY (K, M)``, row-stat vectors ``(1, K)`` / ``(1, M)``,
    scalars 0-d.
    """

    # Data (device-resident, possibly row-sharded over a mesh).
    X: jax.Array
    WX: jax.Array
    Y: Optional[jax.Array]
    WY: Optional[jax.Array]
    weights: Optional[jax.Array]

    # Global products.
    XTX: jax.Array
    XTY: Optional[jax.Array]

    # Global statistics (conditional on the center/scale flags).
    sum_X: Optional[jax.Array]
    sum_Y: Optional[jax.Array]
    sum_sq_X: Optional[jax.Array]
    sum_sq_Y: Optional[jax.Array]
    sum_w: Optional[jax.Array]
    num_nonzero_w: Optional[jax.Array]

    @property
    def N(self) -> int:
        return self.X.shape[0]

    @property
    def K(self) -> int:
        return self.X.shape[1]

    @property
    def M(self) -> Optional[int]:
        return None if self.Y is None else self.Y.shape[1]
