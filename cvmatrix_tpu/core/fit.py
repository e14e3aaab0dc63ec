"""Dataset-wide precompute (the "fit" step).

Reproduces the semantics of the reference fit stack
(``cvmatrix/cvmatrix.py:207-328`` entry; ``_init_mats`` :1153, ``_init_mat``
:1131, ``_init_weighted_mats`` :1193, ``_init_matrix_products`` :1209,
``_init_stats`` :1219) as a single pure function producing a
:class:`~cvmatrix_tpu.core.state.FitState`.

Design notes:
- The two global products ``XTX = WX^T X`` and ``XTY = WX^T Y`` are fused
  into ONE contraction over ``[X | Y]`` so the (large) ``WX`` operand
  streams from device memory once. Per-output-column results are identical
  to separate products.
- Contractions route through :func:`cvmatrix_tpu.ops.precise.contract`
  (a native float64 ``dot_general`` unless ``matmul_mode="exact"``).
- Under a ``jax.sharding`` mesh with ``X``/``Y``/``weights`` row-sharded,
  this same function compiles to per-shard partial products + an XLA
  ``psum`` over the row axis — no separate distributed code path is needed
  (GSPMD inserts the collectives).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..config import CVConfig
from ..ops.precise import contract
from ..utils.tracing import is_concrete
from .state import FitState

__all__ = ["fit"]


def _init_mat(mat, dtype):
    """Cast to dtype and promote 1-D inputs to a column (ref :1131-1151).

    The reference's ``copy`` knob does not apply: JAX arrays are immutable,
    so external mutation of the caller's buffer can never alias into the
    fitted state.
    """
    mat = jnp.asarray(mat, dtype=dtype)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    return mat


def fit(
    config: CVConfig,
    X,
    Y=None,
    weights: Optional[object] = None,
    *,
    validate: bool = True,
) -> FitState:
    """Compute the dataset-wide products and statistics.

    Raises ``ValueError`` for negative weights when values are concrete
    (ref :1186-1189); under tracing the check is skipped (host pre-flight
    contract, ref :620-624).
    """
    dtype = config.dtype
    X = _init_mat(X, dtype)
    Y_arr = None if Y is None else _init_mat(Y, dtype)
    w = None if weights is None else _init_mat(weights, dtype)

    if w is not None and validate and is_concrete(w):
        if bool(jnp.any(w < 0)):
            raise ValueError("Weights must be non-negative.")

    # Weighted matrices (ref :1193-1207). Unweighted: aliases, no copies.
    if w is None:
        WX = X
        WY = Y_arr
    else:
        WX = X * w
        WY = Y_arr * w if (Y_arr is not None and config.needs_WY) else None

    # Global products (ref :1209-1217), fused over [X | Y]. The X block of
    # the fused product is symmetric (X^T W X), which the exact path
    # exploits at wide K (SYRK block skipping, see ops.precise.contract).
    if Y_arr is not None:
        prod = contract(WX, jnp.concatenate([X, Y_arr], axis=1),
                        mode=config.matmul_mode, symmetric_k=X.shape[1],
                        unweighted_x=w is None)
        XTX = prod[:, : X.shape[1]]
        XTY = prod[:, X.shape[1]:]
    else:
        XTX = contract(WX, X, mode=config.matmul_mode,
                       symmetric_k=X.shape[1], unweighted_x=w is None)
        XTY = None

    # Global statistics (ref :1219-1243), conditional on the flags.
    n = X.shape[0]
    sum_w = num_nonzero_w = None
    if config.any_stats:
        if w is not None:
            sum_w = jnp.sum(w)
            num_nonzero_w = jnp.count_nonzero(w)
        else:
            sum_w = jnp.asarray(n, dtype=dtype)
            num_nonzero_w = jnp.asarray(n)
    sum_X = (
        jnp.sum(WX, axis=0, keepdims=True) if config.needs_sum_X else None
    )
    sum_Y = (
        jnp.sum(WY, axis=0, keepdims=True)
        if (config.needs_sum_Y and Y_arr is not None)
        else None
    )
    # sq_X / sq_Y are deliberately NOT materialised (see FitState docstring);
    # only their column sums are kept (ref :1234-1243).
    sum_sq_X = (
        jnp.sum(WX * X, axis=0, keepdims=True) if config.scale_X else None
    )
    sum_sq_Y = (
        jnp.sum(WY * Y_arr, axis=0, keepdims=True)
        if (config.scale_Y and Y_arr is not None)
        else None
    )

    return FitState(
        X=X,
        WX=WX,
        Y=Y_arr,
        WY=WY,
        weights=w,
        XTX=XTX,
        XTY=XTY,
        sum_X=sum_X,
        sum_Y=sum_Y,
        sum_sq_X=sum_sq_X,
        sum_sq_Y=sum_sq_Y,
        sum_w=sum_w,
        num_nonzero_w=num_nonzero_w,
    )
