"""Multi-device / multi-host execution over a ``jax.sharding.Mesh``.

The reference is strictly single-process (SURVEY.md §2: no collectives of any
kind exist); this module is the scaling layer it calls for:

- **Rows** (the dataset axis N) are sharded across the mesh — the analogue of
  data/sequence parallelism for this workload (SURVEY.md §5). ``fit`` then
  consists of per-shard partial products assembled with ``psum`` over the
  device interconnect: GSPMD inserts the collective automatically from the
  sharding annotations.
- **Folds** are an embarrassingly parallel batch axis: validation blocks are
  first assembled from the row shards with a shard-local
  mask-and-reduce-scatter gather (communication = the gathered rows only,
  never the dataset), then the fold math runs fold-sharded across all
  devices.

Everything here reuses the exact numerics of :mod:`cvmatrix_tpu.core` — the
fold math is the same ``training_matrices_from_blocks``; only data movement
differs.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import CVConfig
from ..core.batch import batched_matrices_from_blocks
from ..core.fit import fit as _fit
from ..core.fold import FoldBlocks
from ..core.state import FitState
from ..utils.fnkey import fn_cache_key as _fn_cache_key

__all__ = [
    "make_mesh",
    "fit_sharded",
    "sharded_training_matrices",
    "sharded_cross_validate_reduce",
]

ROWS = "rows"


def make_mesh(devices=None, axis_name: str = ROWS) -> Mesh:
    """A 1-D mesh over all (or the given) devices, axis ``rows``.

    Rows is the only scaling axis this workload needs (SURVEY.md §2
    "Parallelism strategies"): the same axis is reused for fold parallelism
    in the per-fold phase.
    """
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def _row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS, None))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _pad_rows(X, Y, weights, n_shards: int):
    """Zero-pad rows to a multiple of the shard count.

    Padding rows carry zero WEIGHT, which preserves every statistic exactly:
    for originally-unweighted data we materialise unit weights with zero pad
    entries (``sum_w = N`` and ``nnz = N`` still hold, ``WX = X`` exactly).
    """
    n = X.shape[0]
    pad = (-n) % n_shards
    if pad == 0:
        return X, Y, weights, n
    X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)])
    if Y is not None:
        Y = np.concatenate([Y, np.zeros((pad, Y.shape[1]), Y.dtype)])
    if weights is None:
        weights = np.ones(n, X.dtype)
    else:
        weights = np.asarray(weights, X.dtype).reshape(-1)
    weights = np.concatenate([weights, np.zeros(pad, X.dtype)])
    return X, Y, weights, n


def fit_sharded(
    config: CVConfig,
    mesh: Mesh,
    X,
    Y=None,
    weights=None,
) -> FitState:
    """Row-sharded fit: per-shard partials + psum-assembled globals.

    Inputs are host arrays (or globally-addressable jax arrays); data fields
    of the returned state are row-sharded over ``mesh``, products/statistics
    replicated. The numerics are those of :func:`cvmatrix_tpu.core.fit.fit`
    — GSPMD turns its contractions/reductions into per-shard partials plus
    ``psum`` collectives over the ``rows`` axis.
    """
    n_shards = mesh.shape[ROWS]
    X = np.asarray(X, config.dtype)
    if X.ndim == 1:
        X = X[:, None]
    Yn = None if Y is None else np.asarray(Y, config.dtype)
    if Yn is not None and Yn.ndim == 1:
        Yn = Yn[:, None]
    X, Yn, weights, _ = _pad_rows(X, Yn, weights, n_shards)

    row = _row_sharding(mesh)
    rep = _replicated(mesh)
    Xd = jax.device_put(X, row)
    Yd = None if Yn is None else jax.device_put(Yn, row)
    wd = (
        None
        if weights is None
        else jax.device_put(np.asarray(weights).reshape(-1, 1), row)
    )

    # Trace once eagerly (abstractly) to learn which fields exist, then jit
    # with matching out_shardings.
    shape_state = jax.eval_shape(
        partial(_fit, config, validate=False), Xd, Yd, wd
    )
    fitted = _sharded_fit_program(
        config, fit_out_spec(shape_state, row, rep)
    )(Xd, Yd, wd)
    # Weight validation is data-dependent; do it host-side (eagerly) here.
    if weights is not None and bool(jnp.any(fitted.weights < 0)):
        raise ValueError("Weights must be non-negative.")
    return fitted


def fit_out_spec(state: FitState, row, rep) -> FitState:
    """Output shardings for a sharded fit: data fields row-sharded,
    products/statistics replicated. One helper shared by the single- and
    multi-process entry points — the 13-field map must not drift between
    copies (a field re-marked in one path only would silently reshard)."""
    def mark(x, s):
        return None if x is None else s

    return FitState(
        X=row,
        WX=row,
        Y=mark(state.Y, row),
        WY=mark(state.WY, row),
        weights=mark(state.weights, row),
        XTX=rep,
        XTY=mark(state.XTY, rep),
        sum_X=mark(state.sum_X, rep),
        sum_Y=mark(state.sum_Y, rep),
        sum_sq_X=mark(state.sum_sq_X, rep),
        sum_sq_Y=mark(state.sum_sq_Y, rep),
        sum_w=mark(state.sum_w, rep),
        num_nonzero_w=mark(state.num_nonzero_w, rep),
    )


@lru_cache(maxsize=32)
def _sharded_fit_program(config, out_spec):
    """Cached jitted sharded fit (the out_shardings FitState is frozen and
    hashable; a fresh per-call wrapper would recompile every refit)."""
    return jax.jit(partial(_fit, config, validate=False),
                   out_shardings=out_spec)


def _gather_sources(config: CVConfig, state: FitState, return_XTY: bool):
    """The row-sharded streams a config's gathers actually consume.

    Weighted configs gather only ``X, w`` (and ``Y``) — NOT the derived
    ``WX``/``WY`` planes: ``WX[i] = w[i] * X[i]`` row-wise, so the products
    are reformed after the collective from the same operands (bitwise
    identical), roughly halving the gathered bytes on the wire.
    """
    if state.weights is None:
        sources = {"WX": state.WX}  # unweighted: WX aliases the X stream
        if return_XTY:
            sources["Y"] = state.Y
        return sources
    sources = {"X": state.X, "w": state.weights}
    if return_XTY:
        sources["Y"] = state.Y
    return sources


def _local_gather_scatter(arrs, idx, shard_rows, single_dev=False):
    """Fold-sharded mask-and-reduce-scatter row gather (inside ``shard_map``).

    ``idx``: (F, L) global row indices; this shard owns rows
    ``[r0, r0 + shard_rows)``. Each shard contributes its owned rows (zeros
    elsewhere) for every fold; the collective is ``psum_scatter`` over the
    fold axis, so each device receives only ITS ``F / n_dev`` fold slice,
    already summed. A reduce-scatter instead of an all-reduce moves 1/n_dev
    the wire bytes, and the blocks land fold-sharded,
    so the fold math pays no replicated->fold-sharded reshard.
    ``idx.shape[0]`` must be a multiple of the mesh size (callers pad the
    fold axis).

    ``single_dev=True`` (1-device mesh, known statically at trace time):
    every row is local and the collective is the identity, so the gather
    degenerates to plain takes — no masking pass, no concat, no scatter.
    """
    if single_dev:
        return {k: a[idx] for k, a in arrs.items()}
    r0 = jax.lax.axis_index(ROWS) * shard_rows
    li = idx - r0
    inb = (li >= 0) & (li < shard_rows)
    lc = jnp.clip(li, 0, shard_rows - 1)

    # ONE fused collective: concatenate every stream's contribution on the
    # feature axis and reduce-scatter once, instead of one collective per
    # stream (launch overhead and message count scale with the number of
    # collectives, not just bytes).
    parts = []
    widths = []
    for a in arrs.values():
        rows = a[lc]  # (F, L, C)
        parts.append(jnp.where(inb[..., None], rows, 0))
        widths.append(rows.shape[-1])
    stacked = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
    fused = jax.lax.psum_scatter(
        stacked, ROWS, scatter_dimension=0, tiled=True,
    )
    out = {}
    off = 0
    for k, c in zip(arrs, widths):
        out[k] = fused[..., off:off + c]
        off += c
    return out


def _blocks_from_gathered(config, weighted, gathered, mask_batch, return_XTY):
    """Reproduce gather_val_blocks' aliasing/masking rules on batched blocks.

    ``weighted``: whether the fitted state carries weights (a static bool so
    cached program builders need no state object).
    """
    gX = gathered.get("X")
    gY = gathered.get("Y")
    gw = gathered.get("w")
    if weighted:
        # Reform the weighted planes from the gathered operands (same
        # row-wise products the fit built — bitwise identical to gathering
        # state.WX/state.WY, at half the collective volume).
        gWX = gX * gw
        gWY = None if gY is None or not config.needs_WY else gY * gw
    else:
        gWX = gathered["WX"]
        gWY = None

    Xv_u = gWX if not weighted else gX
    Xv_w = gWX if mask_batch is None else gWX * mask_batch[..., None]
    if return_XTY:
        if not weighted or not config.needs_WY:
            Yv_raw = gY
            Yv_u = Yv_raw
        else:
            Yv_raw = gWY
            Yv_u = gY
        Yv_w = Yv_raw if mask_batch is None else Yv_raw * mask_batch[..., None]
    else:
        Yv_w = Yv_u = None
    if gw is None:
        w_val = None
    else:
        w_val = gw if mask_batch is None else gw * mask_batch[..., None]
    return FoldBlocks(Xv_w, Xv_u, Yv_w, Yv_u, w_val, mask_batch)


@lru_cache(maxsize=64)
def _gather_program(mesh: Mesh, names: tuple, shard_rows: int):
    """Cached jitted reduce-scatter gather (fresh per-call wrappers
    recompile the whole program every invocation — module-level caching is
    mandatory for warm sweeps). Output is fold-sharded over the mesh."""
    single = mesh.shape[ROWS] == 1
    return jax.jit(jax.shard_map(
        lambda arrs, idx: _local_gather_scatter(arrs, idx, shard_rows,
                                                single_dev=single),
        mesh=mesh,
        in_specs=({k: P(ROWS, None) for k in names}, P()),
        out_specs={k: P(ROWS) for k in names},
    ))


def _globals_only(config: CVConfig, state: FitState) -> FitState:
    """Small replicated globals only: the fold math never touches the big
    data fields (they were consumed by the gather phase)."""
    return FitState(
        X=jnp.zeros((1, state.K), config.dtype),
        WX=jnp.zeros((1, state.K), config.dtype),
        # (1, M) dummy keeps state.M derivable; the fold math only reads
        # blocks, never Y's data.
        Y=(
            None if state.Y is None
            else jnp.zeros((1, state.M), config.dtype)
        ),
        WY=None,
        weights=None,
        XTX=state.XTX,
        XTY=state.XTY,
        sum_X=state.sum_X,
        sum_Y=state.sum_Y,
        sum_sq_X=state.sum_sq_X,
        sum_sq_Y=state.sum_sq_Y,
        sum_w=state.sum_w,
        num_nonzero_w=state.num_nonzero_w,
    )


def sharded_training_matrices(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    mesh: Mesh,
    return_XTX: bool = True,
    return_XTY: bool = True,
    trim_padding: bool = True,
):
    """All folds' training matrices on a mesh: gather, then fold-sharded math.

    ``idx_batch`` (F, L): per-fold validation indices (padded; pass
    ``mask_batch`` for unequal fold sizes). Outputs are sharded over folds
    (leading axis) across the mesh.

    The fold axis is padded internally to a multiple of the mesh size.
    ``trim_padding=True`` (default) slices the duplicates off — convenient,
    but a non-multiple fold count can no longer be evenly fold-sharded, so
    XLA reshards (gathers) the trimmed result. Pass ``trim_padding=False``
    to keep the padded, still-sharded output and receive
    ``(results, n_folds)``: consume ``results[:n_folds]`` shard-locally (the
    trailing entries are duplicates of fold 0).
    """
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    idx_batch = jnp.asarray(idx_batch)
    if mask_batch is not None:
        mask_batch = jnp.asarray(mask_batch, config.dtype)
    # Pad the fold axis to a multiple of the mesh size (duplicating fold 0);
    # the duplicates are sliced off after the fold-sharded computation.
    n_folds = idx_batch.shape[0]
    pad_f = (-n_folds) % mesh.shape[ROWS]
    if pad_f:
        idx_batch = jnp.concatenate(
            [idx_batch, jnp.broadcast_to(idx_batch[:1], (pad_f,) + idx_batch.shape[1:])]
        )
        if mask_batch is not None:
            mask_batch = jnp.concatenate(
                [mask_batch,
                 jnp.broadcast_to(mask_batch[:1], (pad_f,) + mask_batch.shape[1:])]
            )
    rep = _replicated(mesh)
    fold_sharded = NamedSharding(mesh, P(ROWS))

    # Gather with a fold-axis reduce-scatter: blocks land ALREADY
    # fold-sharded (1/n_dev the collective bytes of the replicating psum)
    # and the fold math consumes them in place — no reshard hop.
    n_shards = mesh.shape[ROWS]
    shard_rows = state.X.shape[0] // n_shards
    sources = _gather_sources(config, state, return_XTY)
    gathered = _gather_program(
        mesh, tuple(sources.keys()), shard_rows
    )(sources, jax.device_put(idx_batch, rep))
    blocks = _blocks_from_gathered(
        config, state.weights is not None, gathered,
        None if mask_batch is None else jax.device_put(mask_batch,
                                                       fold_sharded),
        return_XTY,
    )

    globals_only = _globals_only(config, state)

    out = _fold_math_program(
        config, return_XTX, return_XTY, fold_sharded
    )(globals_only, blocks)
    if not trim_padding:
        return out, n_folds
    if pad_f:
        out = jax.tree.map(lambda a: a[:n_folds], out)
    return out


@lru_cache(maxsize=64)
def _fold_math_program(config, return_XTX, return_XTY, fold_sharded):
    """Cached jitted fold-math phase of :func:`sharded_training_matrices`."""
    return jax.jit(
        partial(batched_matrices_from_blocks, config,
                return_XTX=return_XTX, return_XTY=return_XTY),
        out_shardings=fold_sharded,
    )


def sharded_cross_validate_reduce(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    mesh: Mesh,
    reduce_fn,
    batch_size: Optional[int] = None,
    return_XTX: bool = True,
    return_XTY: bool = True,
    hbm_budget_bytes: float = 4e9,
):
    """Mesh-parallel, single-program CV sweep with an on-device reduction.

    The multi-device counterpart of :func:`models.sweep.cross_validate_reduce`:
    ONE compiled program scans fold chunks; each step gathers the chunk's
    validation rows from the row shards (mask-and-reduce-scatter), splits the chunk's
    folds across the mesh, runs the fold math shard-locally and immediately
    reduces with ``reduce_fn``. Fold matrices never leave
    their device; only the reductions are returned (stacked, fold-major).

    ``batch_size`` (global folds per scan step) defaults to the same
    per-device HBM budget the single-chip sweep uses — per-chunk fixed
    costs (gather collective, dispatch) amortize over the largest chunk
    that fits.
    """
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    n_dev = mesh.shape[ROWS]
    idx = jnp.asarray(idx_batch)
    n_folds = idx.shape[0]
    if batch_size is None:
        # Per-DEVICE budget, like materialize_sweep: two chunks of fold
        # outputs plus the gathered block streams for this chunk's folds.
        k = state.K
        c = (k if return_XTX else 0) + ((state.M or 0) if return_XTY else 0)
        itemsize = np.dtype(config.dtype).itemsize
        per_fold = 2 * itemsize * max(k * c, 1)
        per_fold += 4 * itemsize * idx.shape[1] * (k + (state.M or 0) + 1)
        batch_size = n_dev * max(
            1, min(2000, int(hbm_budget_bytes / per_fold))
        )
    mask = None if mask_batch is None else jnp.asarray(mask_batch, config.dtype)
    # Chunk size: a multiple of the mesh size, equalized over chunks.
    bs = max(n_dev, min(batch_size, n_folds) // n_dev * n_dev)
    n_chunks = -(-n_folds // bs)
    bs = -(-(-(-n_folds // n_chunks)) // n_dev) * n_dev
    n_chunks = -(-n_folds // bs)
    pad = n_chunks * bs - n_folds
    if pad:
        idx = jnp.concatenate(
            [idx, jnp.broadcast_to(idx[-1:], (pad,) + idx.shape[1:])]
        )
        if mask is not None:
            mask = jnp.concatenate(
                [mask, jnp.broadcast_to(mask[-1:], (pad,) + mask.shape[1:])]
            )
    idx_c = idx.reshape(n_chunks, bs, idx.shape[1])
    mask_c = None if mask is None else mask.reshape(n_chunks, bs, mask.shape[1])

    shard_rows = state.X.shape[0] // n_dev
    bs_local = bs // n_dev
    sources = _gather_sources(config, state, return_XTY)
    globals_only = _globals_only(config, state)

    red = _reduce_program(
        config, mesh, tuple(sources.keys()), state.weights is not None,
        return_XTX, return_XTY, shard_rows, bs_local, reduce_fn,
    )(sources, globals_only, idx_c, mask_c)
    red = jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:])[:n_folds], red)
    return red


def _reduce_program(config, mesh, names, weighted, return_XTX,
                    return_XTY, shard_rows, bs_local, reduce_fn):
    """Cached jitted program for :func:`sharded_cross_validate_reduce`.

    Keyed on everything the trace depends on; ``reduce_fn`` is keyed by
    its code object + closure/default values (see
    :func:`cvmatrix_tpu.utils.fnkey.fn_cache_key`),
    so a fresh-but-identical lambda per call still hits the cache.
    """
    return _reduce_program_cached(
        config, mesh, names, weighted, return_XTX, return_XTY,
        shard_rows, bs_local, _fn_cache_key(reduce_fn),
        _Uncached(reduce_fn),
    )


class _Uncached:
    """Hashable carrier that compares equal to everything of its type.

    Lets the traced ``reduce_fn`` ride through ``lru_cache`` without
    contributing to the key (the real key is ``fn_cache_key``'s)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __hash__(self):
        return 0

    def __eq__(self, other):
        return isinstance(other, _Uncached)


@lru_cache(maxsize=64)
def _reduce_program_cached(config, mesh, names, weighted, return_XTX,
                           return_XTY, shard_rows, bs_local,
                           reduce_key, reduce_carrier):
    reduce_fn = reduce_carrier.value
    single = mesh.shape[ROWS] == 1

    def body(srcs, st, ic, mc):
        def step(carry, chunk):
            ci, cm = chunk
            # Reduce-scatter gather: each device receives ONLY its
            # bs_local fold slice (1/n_dev the collective bytes of the
            # replicate-then-slice it replaces).
            gathered = _local_gather_scatter(srcs, ci, shard_rows,
                                             single_dev=single)
            r0 = jax.lax.axis_index(ROWS) * bs_local
            my_mask = None if cm is None else jax.lax.dynamic_slice_in_dim(
                cm, r0, bs_local, 0)
            my = _blocks_from_gathered(config, weighted, gathered, my_mask,
                                       return_XTY)
            mats, stats = batched_matrices_from_blocks(
                config, st, my,
                return_XTX=return_XTX, return_XTY=return_XTY,
            )
            return carry, jax.vmap(reduce_fn)(mats, stats)

        _, red = jax.lax.scan(step, None, (ic, mc))
        return red  # (n_chunks, bs_local, ...)

    return jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=({k: P(ROWS, None) for k in names}, P(), P(), P()),
            out_specs=P(None, ROWS),
        )
    )
