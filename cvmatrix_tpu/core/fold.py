"""Per-fold training-matrix computation (the inner loop of cross-validation).

Pure-functional re-design of the reference per-fold stack
(``cvmatrix/cvmatrix.py:754-941`` dispatch/gathers, ``:589-752`` stats,
``:943-1010`` the downdate kernel, ``:1012-1129`` moment math): every function
here is a pure function of ``(config, state, val_indices[, mask])`` and is
traceable by ``jax.jit`` / ``jax.vmap`` / ``shard_map``.

The algorithm (Engstrøm & Jensen, Algorithms 2-7): starting from the global
``XTX = X^T W X`` / ``XTY = X^T W Y``, each fold's *training* matrices are
produced by subtracting the validation block's contribution (downdating) and
applying the weighted centering/scaling corrections as a rank-one mean term
and an outer-product std divide — per-fold cost is independent of the
training-set size.

Layering: the fold math is split into
  1. :func:`gather_val_blocks` — row gathers of the validation block, and
  2. :func:`training_matrices_from_blocks` — fold math on gathered blocks
     plus the small replicated globals,
so that on a device mesh step 1 can run as a shard-local mask-and-reduce
(``parallel/``) while step 2 runs fold-sharded, without duplicating any of
the numerics.

Deviations from the reference (bit-compatible):
- The two downdate products share one contraction over ``[X_val | Y_val]``
  (one pass over the gathered validation rows).
- Rank-one terms ``mean_X^T @ mean_2`` are computed as broadcasted
  elementwise outer products, not 1-contractions — mathematically identical,
  and XLA fuses them into the epilogue instead of launching a matmul.
- Squared validation rows are recomputed from the gathered rows instead of
  gathering a materialised ``sq_X`` (see ``FitState`` docstring).
- A ``mask`` argument (no reference equivalent) supports padding fold-index
  batches to a common length for ``jax.vmap``: masked-out rows contribute
  exactly nothing to sums, counts, and products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..config import CVConfig
from ..ops.precise import contract
from ..utils.tracing import is_concrete
from .state import FitState

__all__ = [
    "FoldBlocks",
    "gather_val_blocks",
    "training_matrices_from_blocks",
    "training_matrices",
    "training_XTX",
    "training_XTY",
    "training_XTX_XTY",
    "training_statistics",
]


class FoldBlocks(NamedTuple):
    """Gathered validation rows (ref ``_get_val_matrices``, :898-941).

    ``Xv_w`` rows are weighted (``WX[v]``) and mask-zeroed; ``Xv_u`` rows are
    unweighted and unmasked (they alias the same gather when weights are
    absent). ``w_val`` is ``None`` for unweighted data. ``mask`` is ``None``
    or (L,) 0/1; ``n_val`` is the unpadded count when no mask is used.
    """

    Xv_w: jnp.ndarray
    Xv_u: jnp.ndarray
    Yv_w: Optional[jnp.ndarray]
    Yv_u: Optional[jnp.ndarray]
    w_val: Optional[jnp.ndarray]
    mask: Optional[jnp.ndarray]


def gather_val_blocks(
    config: CVConfig, state: FitState, v, mask, return_XTY: bool
) -> FoldBlocks:
    """Row-gather the validation block from (possibly sharded) data."""
    if mask is not None:
        # Partitioner.padded_batches builds f64 masks; an uncast f64 mask
        # would silently promote an f32 config's whole fold math to f64.
        mask = jnp.asarray(mask, config.dtype)
    Xv_raw = state.WX[v]
    Xv_u = Xv_raw if state.weights is None else state.X[v]
    Xv_w = Xv_raw if mask is None else Xv_raw * mask[:, None]
    if return_XTY:
        # Aliasing rule at ref :929-937: Y_val is the *unweighted* gather
        # when weights are absent or no Y statistics are ever needed.
        if state.weights is None or not config.needs_WY:
            Yv_raw = state.Y[v]
            Yv_u = Yv_raw
        else:
            Yv_raw = state.WY[v]
            Yv_u = state.Y[v]
        Yv_w = Yv_raw if mask is None else Yv_raw * mask[:, None]
    else:
        Yv_w = Yv_u = None
    if state.weights is None:
        w_val = None
    else:
        w_val = state.weights[v]
        if mask is not None:
            w_val = w_val * mask[:, None]
    return FoldBlocks(Xv_w, Xv_u, Yv_w, Yv_u, w_val, mask)


def _checkable(state: FitState, v, mask) -> bool:
    """Whether the data-dependent validity raises can run eagerly.

    The checked predicates read the fold indices AND the state's weight
    scalars, so EVERY input must be concrete — a fused ``jit(fit + fold)``
    traces the state even when the indices are host constants, and a
    ``bool()`` on the traced predicate would crash the trace. Deferred
    checks run in the host-side pre-flight instead (Partitioner.validate).
    """
    return (
        is_concrete(v)
        and (mask is None or is_concrete(mask))
        and is_concrete(state.sum_w)
        and (state.num_nonzero_w is None or is_concrete(state.num_nonzero_w))
        and (state.weights is None or is_concrete(state.weights))
    )


def _train_weight_scalars(state: FitState, blocks: FoldBlocks, *, check: bool):
    """Training-set weight sum and nonzero count (ref :589-630)."""
    if blocks.w_val is None:
        if blocks.mask is None:
            sum_w_val = blocks.Xv_w.shape[0]  # static
        else:
            sum_w_val = jnp.sum(blocks.mask)
        sum_w_train = state.sum_w - sum_w_val
        num_nonzero_w_train = sum_w_train
    else:
        sum_w_train = state.sum_w - jnp.sum(blocks.w_val)
        num_nonzero_w_train = state.num_nonzero_w - jnp.count_nonzero(
            blocks.w_val
        )
    # Data-dependent validity raise: eager only; deferred to the host-side
    # pre-flight under tracing (ref :619-630).
    if check and bool(num_nonzero_w_train == 0):
        raise ValueError(
            "The number of non-zero weights in the training set must be "
            "greater than zero."
        )
    return sum_w_train, num_nonzero_w_train


def _std_divisor(config: CVConfig, sum_w_train, num_nonzero_w_train, *, check: bool):
    """ref ``_compute_std_divisor`` (:1045-1079)."""
    if check and bool(num_nonzero_w_train <= config.ddof):
        raise ValueError(
            "The number of non-zero weights in the training set must be "
            "greater than `ddof`."
        )
    return (num_nonzero_w_train - config.ddof) * sum_w_train / num_nonzero_w_train


def _train_std(config: CVConfig, sum_sq_train, mean, sum_train, sum_w_train, divisor):
    """One-pass std identity + degenerate clamp (ref :1081-1129).

    ``var = (-2 mean . sum + sum_w mean^2 + sum_sq) / divisor``; variance is
    clamped at 0 and stds <= resolution are replaced by 1 so constant columns
    never divide by ~0 — trace-safe via maximum/where.
    """
    var = (
        -2 * mean * sum_train + sum_w_train * mean**2 + sum_sq_train
    ) / divisor
    std = jnp.sqrt(jnp.maximum(var, 0))
    return jnp.where(std <= config.resolution, jnp.ones_like(std), std)


def _compute_training_stats(
    config: CVConfig,
    state: FitState,
    blocks: FoldBlocks,
    *,
    return_X_mean: bool,
    return_X_std: bool,
    return_Y_mean: bool,
    return_Y_std: bool,
    check: bool,
):
    """Downdated training means/stds (ref ``_compute_training_stats``, :632-752).

    Returns ``(X_mean, X_std, Y_mean, Y_std, sum_w_train)`` with ``None`` for
    statistics not requested.
    """
    if not (return_X_mean or return_X_std or return_Y_mean or return_Y_std):
        return None, None, None, None, None
    sum_w_train, num_nonzero_w_train = _train_weight_scalars(
        state, blocks, check=check
    )
    X_mean = X_std = Y_mean = Y_std = None
    sum_X_train = sum_Y_train = None
    if return_X_mean or return_X_std:
        sum_X_train = state.sum_X - jnp.sum(blocks.Xv_w, axis=0, keepdims=True)
        X_mean = sum_X_train / sum_w_train
    if return_Y_mean or return_Y_std:
        sum_Y_train = state.sum_Y - jnp.sum(blocks.Yv_w, axis=0, keepdims=True)
        Y_mean = sum_Y_train / sum_w_train
    if return_X_std or return_Y_std:
        divisor = _std_divisor(
            config, sum_w_train, num_nonzero_w_train, check=check
        )
    if return_X_std:
        # sq rows recomputed from gathered rows: (WX[v] * mask) . X[v]
        # == gather of the reference's materialised sq_X, exactly.
        sum_sq_X_val = jnp.sum(blocks.Xv_w * blocks.Xv_u, axis=0, keepdims=True)
        X_std = _train_std(
            config,
            state.sum_sq_X - sum_sq_X_val,
            X_mean,
            sum_X_train,
            sum_w_train,
            divisor,
        )
    if return_Y_std:
        sum_sq_Y_val = jnp.sum(blocks.Yv_w * blocks.Yv_u, axis=0, keepdims=True)
        Y_std = _train_std(
            config,
            state.sum_sq_Y - sum_sq_Y_val,
            Y_mean,
            sum_Y_train,
            sum_w_train,
            divisor,
        )
    return (
        X_mean if return_X_mean else None,
        X_std if return_X_std else None,
        Y_mean if return_Y_mean else None,
        Y_std if return_Y_std else None,
        sum_w_train,
    )


def _apply_epilogue(T, mean1, mean2, std1, std2, sum_w_train, center: bool):
    """Rank-one center + outer-product scale (ref :1002-1010)."""
    if center:
        T = T - sum_w_train * (mean1.T * mean2)
    if std1 is not None and std2 is not None:
        return T / (std1.T * std2)
    if std1 is not None:
        return T / std1.T
    if std2 is not None:
        return T / std2
    return T


def training_matrices_from_blocks(
    config: CVConfig,
    state: FitState,
    blocks: FoldBlocks,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    check: bool = False,
):
    """Fold math given already-gathered validation blocks.

    ``state`` supplies only the small replicated globals here (products,
    sums, scalars) — the large data arrays are untouched, so a sharded
    caller can pass the same pytree and XLA dead-code-eliminates the rest.
    """
    # Cross-coupled stat flags (ref :828-831): the XTY mean cross-term
    # cancels only when both sides are centered, so one-sided centering still
    # needs the other side's mean.
    X_mean, X_std, Y_mean, Y_std, sum_w_train = _compute_training_stats(
        config,
        state,
        blocks,
        return_X_mean=config.center_X or (return_XTY and config.center_Y),
        return_X_std=config.scale_X,
        return_Y_mean=return_XTY and (config.center_X or config.center_Y),
        return_Y_std=return_XTY and config.scale_Y,
        check=check,
    )
    stats = (X_mean, X_std, Y_mean, Y_std)

    # Fused downdate: one contraction over [X_val | Y_val] (one pass over the
    # gathered rows), split into the XTX / XTY downdates.
    if return_XTX and return_XTY:
        m2 = jnp.concatenate([blocks.Xv_u, blocks.Yv_u], axis=1)
        # The leading (K, K) downdate block is sum w x x^T — symmetric, so
        # wide-K exact-mode contractions ride the SYRK route like the fit's.
        prod = contract(blocks.Xv_w, m2, mode=config.matmul_mode,
                        symmetric_k=blocks.Xv_u.shape[1])
        k = blocks.Xv_u.shape[1]
        xtx = _apply_epilogue(
            state.XTX - prod[:, :k],
            X_mean,
            X_mean,
            X_std,
            X_std,
            sum_w_train,
            center=config.center_X,
        )
        xty = _apply_epilogue(
            state.XTY - prod[:, k:],
            X_mean,
            Y_mean,
            X_std,
            Y_std,
            sum_w_train,
            center=config.center_X or config.center_Y,
        )
        return (xtx, xty), stats
    if return_XTX:
        prod = contract(blocks.Xv_w, blocks.Xv_u, mode=config.matmul_mode,
                        symmetric_k=blocks.Xv_u.shape[1])
        xtx = _apply_epilogue(
            state.XTX - prod,
            X_mean,
            X_mean,
            X_std,
            X_std,
            sum_w_train,
            center=config.center_X,
        )
        return xtx, stats
    prod = contract(blocks.Xv_w, blocks.Yv_u, mode=config.matmul_mode)
    xty = _apply_epilogue(
        state.XTY - prod,
        X_mean,
        Y_mean,
        X_std,
        Y_std,
        sum_w_train,
        center=config.center_X or config.center_Y,
    )
    return xty, stats


def training_matrices(
    config: CVConfig,
    state: FitState,
    val_indices,
    mask=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
):
    """Training-set ``X^T W X`` and/or ``X^T W Y`` for one fold.

    Mirrors ``CVMatrix._training_matrices`` (ref :754-896): returns
    ``(mat | (XTX, XTY), (X_mean, X_std, Y_mean, Y_std))``.
    """
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    v = jnp.asarray(val_indices)
    check = _checkable(state, v, mask)
    blocks = gather_val_blocks(config, state, v, mask, return_XTY)
    return training_matrices_from_blocks(
        config,
        state,
        blocks,
        return_XTX=return_XTX,
        return_XTY=return_XTY,
        check=check,
    )


def training_XTX(config: CVConfig, state: FitState, val_indices, mask=None):
    """ref ``training_XTX`` (:330-383)."""
    return training_matrices(
        config, state, val_indices, mask, return_XTX=True, return_XTY=False
    )


def training_XTY(config: CVConfig, state: FitState, val_indices, mask=None):
    """ref ``training_XTY`` (:385-449)."""
    return training_matrices(
        config, state, val_indices, mask, return_XTX=False, return_XTY=True
    )


def training_XTX_XTY(config: CVConfig, state: FitState, val_indices, mask=None):
    """ref ``training_XTX_XTY`` (:451-517)."""
    return training_matrices(
        config, state, val_indices, mask, return_XTX=True, return_XTY=True
    )


def training_statistics(
    config: CVConfig, state: FitState, val_indices, mask=None
) -> Tuple:
    """Training means/stds only (ref ``training_statistics``, :519-574).

    Note the flag set differs from :func:`training_matrices` (ref :570-573):
    X mean is returned when ``center_X or scale_X``; Y mean when
    ``(center_Y or scale_Y)`` and Y is present.
    """
    v = jnp.asarray(val_indices)
    has_Y = state.Y is not None
    check = _checkable(state, v, mask)
    need_y_stats = (config.center_Y or config.scale_Y) and has_Y
    blocks = gather_val_blocks(config, state, v, mask,
                               return_XTY=need_y_stats)
    return _compute_training_stats(
        config,
        state,
        blocks,
        return_X_mean=config.center_X or config.scale_X,
        return_X_std=config.scale_X,
        return_Y_mean=(config.center_Y or config.scale_Y) and has_Y,
        return_Y_std=config.scale_Y and has_Y,
        check=check,
    )[:-1]
