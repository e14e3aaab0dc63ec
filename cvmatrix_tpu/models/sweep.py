"""High-level cross-validation sweep driver.

The reference leaves fold batching to the caller (its benchmark/examples
hand-roll size-bucketing + ``jit(vmap(...))`` chunking —
``benchmarks/benchmark.py:136-152``). This driver makes that a library
feature: one call computes every fold's training matrices with

- size-bucketed (or padded+masked) fold batches — one compiled program per
  distinct fold size (or exactly one program with masking),
- chunking chosen from a memory budget so outputs never overflow device
  memory,
- per-fold results yielded as device arrays, keyed by fold.
"""

from __future__ import annotations

import weakref
from functools import lru_cache
from typing import Dict, Hashable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CVConfig
from ..core.batch import training_matrices_batched
from ..core.fit import fit
from ..core.fold import training_matrices
from ..core.state import FitState
from ..utils.fnkey import HashableFn as _HashableFn
from .partitioner import Partitioner

__all__ = ["cross_validate", "cross_validate_reduce", "materialize_cv",
           "materialize_sweep"]


def _auto_batch(n_folds: int, k: int, m: int, itemsize: int,
                budget_bytes: float) -> int:
    per_fold = (k * k + k * m + 4 * (k + m)) * itemsize
    # x3: outputs live while the next chunk is being produced + gather temps.
    return max(1, min(n_folds, int(budget_bytes / (3 * per_fold))))


def _pad_folds(idx, mask, bs):
    """Pad the fold axis to a multiple of ``bs`` by repeating the last fold
    (<1 chunk of duplicate work) — a separate remainder chunk would compile
    a SECOND whole sweep program per configuration."""
    pad = (-idx.shape[0]) % bs
    if pad:
        idx = jnp.concatenate(
            [idx, jnp.broadcast_to(idx[-1:], (pad,) + idx.shape[1:])]
        )
        if mask is not None:
            mask = jnp.concatenate(
                [mask, jnp.broadcast_to(mask[-1:], (pad,) + mask.shape[1:])]
            )
    return idx, mask


def cross_validate(
    config: CVConfig,
    state: FitState,
    partitioner: Partitioner,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    batch_size: Optional[int] = None,
    hbm_budget_bytes: float = 4e9,
    use_padding: bool = False,
) -> Iterator[Tuple[list, object]]:
    """Yield ``(fold_keys, results)`` per compiled chunk, covering all folds.

    ``results`` has the same structure as :func:`training_matrices` with a
    leading fold axis. With ``use_padding=True`` all folds run through ONE
    program (padded + masked); otherwise one program per distinct fold size.
    """
    k = state.K
    m = state.M or 0
    itemsize = np.dtype(config.dtype).itemsize

    fold_fn = _cv_fold_fn(config, return_XTX, return_XTY, True)
    fold_fn_nomask = _cv_fold_fn(config, return_XTX, return_XTY, False)

    if use_padding:
        keys, idx, mask = partitioner.padded_batches()
        groups = [(keys, idx, mask)]
    else:
        groups = [
            (ks, batch, None) for ks, batch in partitioner.size_buckets()
        ]

    for keys, idx, mask in groups:
        bs = batch_size or _auto_batch(len(keys), k, m, itemsize,
                                       hbm_budget_bytes)
        idx_d = jnp.asarray(idx)
        mask_d = None if mask is None else jnp.asarray(mask, config.dtype)
        for s in range(0, len(keys), bs):
            chunk_idx = idx_d[s : s + bs]
            if mask_d is None:
                out = fold_fn_nomask(state, chunk_idx)
            else:
                out = fold_fn(state, chunk_idx, mask_d[s : s + bs])
            yield keys[s : s + bs], out


@lru_cache(maxsize=128)
def _cv_fold_fn(config, return_XTX, return_XTY, with_mask):
    """Cached jitted vmapped fold program for :func:`cross_validate`
    (a fresh per-call ``jax.jit`` wrapper would recompile on every sweep)."""
    if with_mask:
        return jax.jit(
            jax.vmap(
                lambda st, v, mk: training_matrices(
                    config, st, v, mk,
                    return_XTX=return_XTX, return_XTY=return_XTY,
                ),
                in_axes=(None, 0, 0),
            ),
        )
    return jax.jit(
        jax.vmap(
            lambda st, v: training_matrices(
                config, st, v,
                return_XTX=return_XTX, return_XTY=return_XTY,
            ),
            in_axes=(None, 0),
        ),
    )


def cross_validate_reduce(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    reduce_fn,
    return_XTX: bool = True,
    return_XTY: bool = True,
    batch_size: int = 512,
):
    """Map ``reduce_fn`` over every fold's training matrices — ON DEVICE.

    The single-dispatch CV sweep. :func:`cross_validate` returns control to
    Python between chunks; at LOOCV scale the per-chunk dispatch latency then
    rivals the math itself. This driver instead compiles ONE program: a
    ``lax.scan`` over fold chunks whose body computes a chunk's training
    matrices with ``jax.vmap`` and immediately consumes them with
    ``reduce_fn`` — fold outputs never leave device memory, and only the
    (small) reductions are stacked and returned. This mirrors real
    downstream use (e.g. per-fold regression coefficients), where the
    K x K / K x M matrices are intermediates, not artifacts.

    Parameters
    ----------
    idx_batch : (P, L) per-fold validation indices (see
        :meth:`Partitioner.padded_batches`). ``P`` is padded internally to a
        multiple of ``batch_size`` by repeating the last fold; padded results
        are dropped before returning.
    mask_batch : optional (P, L) 0/1 validity mask for padded fold rows.
    reduce_fn : ``(matrices, stats) -> pytree`` applied per fold under
        ``vmap`` (so it must be traceable). ``matrices``/``stats`` have the
        same structure as :func:`training_matrices` for one fold.
    batch_size : folds per scan step; bounds peak device memory for fold
        outputs.

    Returns the stacked reductions with leading axis ``P``.
    """
    idx = jnp.asarray(idx_batch)
    n_folds = idx.shape[0]
    mask = None if mask_batch is None else jnp.asarray(mask_batch, config.dtype)
    bs = min(batch_size, n_folds)
    # Equalize chunk sizes: padding to a multiple of a near-n chunk size
    # can almost double the sweep (n=1000, bs=953 -> padded to 1906).
    n_chunks = -(-n_folds // bs)
    bs = -(-n_folds // n_chunks)
    idx, mask = _pad_folds(idx, mask, bs)
    n_chunks = idx.shape[0] // bs
    idx_c = idx.reshape(n_chunks, bs, *idx.shape[1:])
    mask_c = None if mask is None else mask.reshape(n_chunks, bs, *mask.shape[1:])

    # HashableFn: reduce_fn is a static arg, and static args hash by
    # identity — a fresh-but-identical lambda per call would recompile the
    # whole sweep program. The wrapper keys on code + closure values.
    out = _reduce_sweep_jit(
        config, return_XTX, return_XTY, _HashableFn(reduce_fn),
        state, idx_c, mask_c
    )
    out = jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:])[:n_folds], out)
    return out


def _reduce_sweep_impl(config, return_XTX, return_XTY, reduce_fn,
                       state, idx_c, mask_c):
    def body(_, chunk):
        ci, cm = chunk
        mats, stats = training_matrices_batched(
            config, state, ci, cm,
            return_XTX=return_XTX, return_XTY=return_XTY,
        )
        return None, jax.vmap(reduce_fn)(mats, stats)

    _, stacked = jax.lax.scan(body, None, (idx_c, mask_c))
    return stacked


# Module-level jit: repeat sweeps with the same (config, flags, reduce_fn)
# and shapes hit the compilation cache instead of re-tracing per call.
_reduce_sweep_jit = jax.jit(_reduce_sweep_impl, static_argnums=(0, 1, 2, 3))


def _chunking(n_folds: int, k: int, c: int, itemsize: int,
              batch_size: Optional[int], hbm_budget_bytes: float):
    """Equalized fold-chunk size for the materialising sweeps.

    The default bounds two chunks of K x C outputs (the loop-carried
    buffer and the chunk being produced) by the memory budget.
    """
    if batch_size is None:
        per_fold = 2 * itemsize * max(k * c, 1)
        batch_size = max(1, min(2000, int(hbm_budget_bytes / per_fold)))
    bs = min(batch_size, n_folds)
    # Equalize chunk sizes (see cross_validate_reduce): pad < n_chunks folds.
    return -(-n_folds // -(-n_folds // bs))


def materialize_sweep(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    batch_size: Optional[int] = None,
    return_XTX: bool = True,
    return_XTY: bool = True,
    hbm_budget_bytes: float = 4e9,
):
    """Produce EVERY fold's training matrices in device memory; return a
    probe scalar.

    The throughput primitive behind the benchmarks: one compiled
    ``lax.fori_loop`` walks the fold chunks, each chunk's full matrices are
    materialised in device memory (written into the loop-carried buffer so
    no fold can be dead-code-eliminated) and overwritten by the next chunk —
    the materialise-then-consume lifecycle of the reference's chunked driver
    (``benchmarks/benchmark.py:148-152``) without per-chunk host dispatch.

    Returns a scalar jax array that depends on the final buffer; waiting on
    it (``block_until_ready`` or a host fetch) is the completion barrier for
    the whole sweep.
    """
    idx = jnp.asarray(idx_batch)
    mask = None if mask_batch is None else jnp.asarray(mask_batch, config.dtype)
    k = state.K
    c = (k if return_XTX else 0) + ((state.M or 0) if return_XTY else 0)
    bs = _chunking(idx.shape[0], k, c, np.dtype(config.dtype).itemsize,
                   batch_size, hbm_budget_bytes)
    idx, mask = _pad_folds(idx, mask, bs)
    n_chunks = idx.shape[0] // bs
    return _materialize_sweep_jit(
        config, bs, n_chunks, return_XTX, return_XTY, state, idx, mask,
    )


def _materialize_sweep_impl(
    config, bs, n_chunks, return_XTX, return_XTY, state, idx, mask,
):
    def chunk_mats(ci, cm):
        out, _ = training_matrices_batched(
            config, state, ci, cm,
            return_XTX=return_XTX, return_XTY=return_XTY,
        )
        return out

    sds = jax.eval_shape(
        chunk_mats,
        jax.ShapeDtypeStruct((bs,) + idx.shape[1:], idx.dtype),
        None if mask is None
        else jax.ShapeDtypeStruct((bs,) + mask.shape[1:], mask.dtype),
    )

    def body(c, carry):
        ci = jax.lax.dynamic_slice_in_dim(idx, c * bs, bs, 0)
        cm = (
            None if mask is None
            else jax.lax.dynamic_slice_in_dim(mask, c * bs, bs, 0)
        )
        return chunk_mats(ci, cm)

    bufs = jax.lax.fori_loop(
        0, n_chunks, body,
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), sds),
    )
    # Explicit element indices: a reshape(-1) of a sliced buffer can force
    # a copy of the whole chunk just to read one element.
    return sum(leaf[(0,) * leaf.ndim] for leaf in jax.tree.leaves(bufs))


# Module-level jit so repeat sweeps hit the compilation cache (a fresh jit
# wrapper per call would recompile the whole fori_loop program every time).
_materialize_sweep_jit = jax.jit(
    _materialize_sweep_impl, static_argnums=(0, 1, 2, 3, 4)
)


# Weight buffers that already passed the non-negativity fetch, keyed by
# object id with WEAK values: an entry dies with its buffer, so the map
# can never alias a new array that recycles a freed id (ids are unique
# among live objects), and it holds no device memory alive. jax.Array is
# unhashable (elementwise __eq__), hence id keys rather than a WeakSet.
_VALIDATED_WEIGHTS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _weights_validated(weights) -> bool:
    return _VALIDATED_WEIGHTS.get(id(weights)) is weights


def _remember_validated(weights) -> None:
    try:
        _VALIDATED_WEIGHTS[id(weights)] = weights
    except TypeError:  # non-weakrefable array flavor: just re-validate later
        pass


def materialize_cv(
    config: CVConfig,
    X,
    Y=None,
    weights=None,
    idx_batch=None,
    mask_batch=None,
    *,
    batch_size: Optional[int] = None,
    return_XTX: bool = True,
    return_XTY: bool = True,
    hbm_budget_bytes: float = 4e9,
    validate: bool = True,
):
    """Fit + full fold sweep as ONE compiled program; returns a probe scalar.

    The total-CV throughput primitive (the reference's headline quantity:
    one fit plus every fold's training matrices,
    ``benchmarks/benchmark.py:148-152``), chained on device with no host
    round trip between the phases.

    Waiting on the returned scalar is the completion barrier for the whole
    fit + sweep.
    """
    from ..utils.tracing import is_concrete

    # Pre-flight the weights contract (ref :1186-1189) BEFORE any device
    # work: the fused program runs fit(validate=False) under jit. NumPy
    # inputs are checked host-side for free; a committed jax array costs
    # one device synchronisation, which a warm sweep at P=1000 notices — so
    # a buffer that already passed is remembered and never re-checked, and
    # callers owning the contract can skip entirely with ``validate=False``
    # (mirroring :func:`~cvmatrix_tpu.core.fit.fit`).
    if validate and weights is not None:
        if not isinstance(weights, jax.Array):
            if np.any(np.asarray(weights) < 0):
                raise ValueError("Weights must be non-negative.")
        elif is_concrete(weights) and not _weights_validated(weights):
            if bool(jnp.any(weights < 0)):
                raise ValueError("Weights must be non-negative.")
            _remember_validated(weights)

    X = jnp.asarray(X, config.dtype)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    Yd = None if Y is None else jnp.asarray(Y, config.dtype)
    if Yd is not None and Yd.ndim == 1:
        Yd = Yd.reshape(-1, 1)
    wd = None if weights is None else jnp.asarray(weights, config.dtype)

    idx = jnp.asarray(idx_batch)
    mask = None if mask_batch is None else jnp.asarray(mask_batch, config.dtype)
    k = X.shape[1]
    m = (Yd.shape[1] if Yd is not None else 0) if return_XTY else 0
    bs = _chunking(idx.shape[0], k, (k if return_XTX else 0) + m,
                   np.dtype(config.dtype).itemsize, batch_size,
                   hbm_budget_bytes)
    idx, mask = _pad_folds(idx, mask, bs)
    n_chunks = idx.shape[0] // bs
    return _materialize_cv_jit(
        config, bs, n_chunks, return_XTX, return_XTY, X, Yd, wd, idx, mask,
    )


def _materialize_cv_impl(
    config, bs, n_chunks, return_XTX, return_XTY, X, Y, w, idx, mask,
):
    state = fit(config, X, Y, w, validate=False)
    return _materialize_sweep_impl(
        config, bs, n_chunks, return_XTX, return_XTY, state, idx, mask,
    )


_materialize_cv_jit = jax.jit(
    _materialize_cv_impl, static_argnums=(0, 1, 2, 3, 4)
)


def cross_validate_dict(
    config: CVConfig,
    state: FitState,
    partitioner: Partitioner,
    **kw,
) -> Dict[Hashable, object]:
    """Materialise :func:`cross_validate` into a fold -> result dict."""
    out: Dict[Hashable, object] = {}
    for keys, res in cross_validate(config, state, partitioner, **kw):
        for i, key in enumerate(keys):
            out[key] = jax.tree.map(lambda a: a[i], res)
    return out
