"""Batched per-fold training matrices.

A (F, L) batch of folds runs as ``jax.vmap`` over the single-fold engine in
:mod:`cvmatrix_tpu.core.fold`; XLA compiles the batched gathers, the batched
(L x K)^T (L x (K + M)) downdate product and the rank-one epilogue. Semantics
are exactly those of ``vmap(training_matrices)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import CVConfig
from .fold import training_matrices, training_matrices_from_blocks
from .state import FitState

__all__ = ["batched_matrices_from_blocks", "training_matrices_batched"]


def training_matrices_batched(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
):
    """Training matrices for a (F, L) batch of folds.

    Returns the same structure as ``vmap(training_matrices)``: matrices with
    a leading fold axis plus the stats 4-tuple.
    """
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")

    idx = jnp.asarray(idx_batch)
    mask = None if mask_batch is None else jnp.asarray(mask_batch, config.dtype)

    def one(v, mk):
        return training_matrices(
            config, state, v, mk,
            return_XTX=return_XTX, return_XTY=return_XTY,
        )

    return jax.vmap(one, in_axes=(0, None if mask is None else 0))(idx, mask)


def batched_matrices_from_blocks(
    config: CVConfig,
    state: FitState,
    blocks,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
):
    """Training matrices for pre-gathered batched :class:`FoldBlocks`.

    The mesh fold path: validation rows arrive from a mask-and-reduce-scatter
    gather over the row shards (``parallel.distributed``). Shard-local: no
    collectives, safe inside ``shard_map``. Returns
    ``(mats, (X_mean, X_std, Y_mean, Y_std))`` with a leading fold axis.
    """

    def one(blks):
        return training_matrices_from_blocks(
            config, state, blks,
            return_XTX=return_XTX, return_XTY=return_XTY,
        )

    return jax.vmap(one)(blocks)
