"""High-level sweep driver: full coverage, both batching modes."""

from itertools import product

import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVConfig, CVMatrix, Partitioner, fit
from cvmatrix_tpu.models.sweep import (
    cross_validate,
    cross_validate_dict,
    cross_validate_reduce,
    materialize_cv,
    materialize_sweep,
)

from .data import make_dataset
from .oracle import NaiveOracle

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset()


@pytest.mark.parametrize("use_padding", [False, True])
def test_sweep_matches_eager(use_padding):
    cfg = CVConfig(True, True, True, True, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    ref = CVMatrix().fit(X_ALL[:, :5], Y_ALL, WEIGHTS)
    p = Partitioner(FOLDS)
    results = cross_validate_dict(cfg, st, p, use_padding=use_padding)
    assert set(results) == set(p.folds_dict)
    for k, ((xtx, xty), stats) in results.items():
        (rx, ry), rstats = ref.training_XTX_XTY(p.get_validation_indices(k))
        assert_allclose(np.asarray(xtx), np.asarray(rx), atol=1e-10)
        assert_allclose(np.asarray(xty), np.asarray(ry), atol=1e-10)
        for a, b in zip(stats, rstats):
            if b is not None:
                assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)


def test_sweep_chunking_covers_all_folds():
    cfg = CVConfig(False, False, False, False, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    p = Partitioner(np.arange(X_ALL.shape[0]) % 97)  # LOOCV-ish, many folds
    seen = []
    for keys, out in cross_validate(cfg, st, p, batch_size=10):
        seen.extend(keys)
        assert out[0][0].shape[0] == len(keys)
    assert sorted(seen) == sorted(p.folds_dict)


@pytest.mark.parametrize("batch_size", [3, 7, 64])
def test_reduce_sweep_matches_eager(batch_size):
    """Single-dispatch on-device sweep: reductions match per-fold eager."""
    cfg = CVConfig(True, True, True, True, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    ref = CVMatrix().fit(X_ALL[:, :5], Y_ALL, WEIGHTS)
    p = Partitioner(np.arange(X_ALL.shape[0]) % 13)  # 13 equal-size folds
    keys, idx, mask = p.padded_batches()

    def reduce_fn(mats, stats):
        xtx, xty = mats
        # a downstream-style reduction: ridge-ish solve statistic + traces
        return {
            "tr": np.trace(np.eye(5)) * 0 + xtx.trace(),
            "xty0": xty[:, 0],
            "mX": stats[0],
        }

    out = cross_validate_reduce(
        cfg, st, idx, mask, reduce_fn=reduce_fn, batch_size=batch_size
    )
    assert out["tr"].shape == (len(keys),)
    assert out["xty0"].shape == (len(keys), 5)
    for i, k in enumerate(keys):
        (rx, ry), rstats = ref.training_XTX_XTY(p.get_validation_indices(k))
        assert_allclose(float(out["tr"][i]), float(np.trace(rx)), atol=1e-10)
        assert_allclose(np.asarray(out["xty0"][i]), np.asarray(ry)[:, 0],
                        atol=1e-10)
        assert_allclose(np.asarray(out["mX"][i]), np.asarray(rstats[0]),
                        atol=1e-10)


def test_reduce_sweep_unequal_folds_masked():
    """Padded+masked heterogeneous folds through the scan sweep."""
    cfg = CVConfig(True, False, False, True, 0)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    ref = CVMatrix(True, False, False, True, 0).fit(X_ALL[:, :5], Y_ALL,
                                                    WEIGHTS)
    p = Partitioner(FOLDS)  # 3 unequal folds -> mask path
    keys, idx, mask = p.padded_batches()
    assert mask is not None
    out = cross_validate_reduce(
        cfg, st, idx, mask, reduce_fn=lambda mats, stats: mats, batch_size=2
    )
    for i, k in enumerate(keys):
        (rx, ry), _ = ref.training_XTX_XTY(p.get_validation_indices(k))
        assert_allclose(np.asarray(out[0][i]), np.asarray(rx), atol=1e-10)
        assert_allclose(np.asarray(out[1][i]), np.asarray(ry), atol=1e-10)


def test_materialize_sweep_probe():
    """Benchmark primitive: covers all folds; fold count padded to the
    chunk size by repeating the last fold (one compiled program)."""
    cfg = CVConfig(True, True, True, True, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    ref = CVMatrix().fit(X_ALL[:, :5], Y_ALL, WEIGHTS)
    idx = np.arange(37)[:, None]  # LOOCV over 37 rows, batch 10 -> pad to 40
    probe = float(materialize_sweep(cfg, st, idx, batch_size=10))
    assert np.isfinite(probe)
    # The probe is the final chunk buffer's first element per output: the
    # last chunk holds folds 30..36 (+3 repeats of 36), so fold 30 leads.
    (x30, y30), _ = ref.training_XTX_XTY(idx[30])
    expect = float(x30[0, 0] + y30[0, 0])
    assert_allclose(probe, expect, rtol=1e-12)


def test_sweep_xtx_only():
    cfg = CVConfig(True, False, True, False, 1)
    st = fit(cfg, X_ALL[:, :5], None, None)
    p = Partitioner(FOLDS)
    d = cross_validate_dict(cfg, st, p, return_XTY=False)
    ref = CVMatrix(True, False, True, False, 1).fit(X_ALL[:, :5], None, None)
    for k, (xtx, stats) in d.items():
        rx, _ = ref.training_XTX(p.get_validation_indices(k))
        assert_allclose(np.asarray(xtx), np.asarray(rx), atol=1e-10)


def test_materialize_cv_matches_fit_plus_sweep():
    """Fused fit+sweep probe equals the separate fit -> materialize_sweep."""
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    n = X_ALL.shape[0]
    P = 10
    idx = np.stack([np.where(np.arange(n) % P == f)[0] for f in range(P)])
    p1 = float(materialize_sweep(cfg, st, idx))
    p2 = float(materialize_cv(cfg, X_ALL, Y_ALL, WEIGHTS, idx))
    assert abs(p1 - p2) <= 1e-9 * max(1.0, abs(p1))


@pytest.mark.parametrize(
    "weighted,dtype,xtx_only",
    [(False, np.float64, False), (True, np.float32, False),
     (True, np.float64, True)],
)
def test_materialize_cv_variants(weighted, dtype, xtx_only):
    """Fused driver parity for unweighted / f32 / XTX-only sweeps."""
    cfg = CVConfig(True, True, False, True, ddof=0, dtype=dtype)
    w = WEIGHTS if weighted else None
    st = fit(cfg, X_ALL, Y_ALL, w)
    n = X_ALL.shape[0]
    idx = np.stack([np.where(np.arange(n) % 8 == f)[0] for f in range(8)])
    kw = dict(return_XTX=True, return_XTY=not xtx_only)
    p1 = float(materialize_sweep(cfg, st, idx, **kw))
    p2 = float(materialize_cv(cfg, X_ALL, Y_ALL, w, idx, **kw))
    tol = 1e-9 if dtype == np.float64 else 1e-4
    assert abs(p1 - p2) <= tol * max(1.0, abs(p1))


def test_materialize_cv_rejects_negative_weights():
    """The fused driver enforces the host-side weight contract (the inner
    fit runs validate=False under jit, so the check must happen eagerly)."""
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    w = np.array(WEIGHTS, copy=True)
    w[3] = -1.0
    idx = np.arange(40).reshape(4, 10)
    with pytest.raises(ValueError, match="non-negative"):
        materialize_cv(cfg, X_ALL, Y_ALL, w, idx)
    # rejects jax arrays too, and a failing buffer is never memoized
    import jax.numpy as jnp

    wj = jnp.asarray(w)
    for _ in range(2):
        with pytest.raises(ValueError, match="non-negative"):
            materialize_cv(cfg, X_ALL, Y_ALL, wj, idx)


def test_materialize_cv_weight_validation_memoized():
    """A committed weights buffer pays the validation fetch ONCE: repeat
    sweeps with the same array skip the blocking device synchronisation,
    and validate=False skips it outright."""
    import jax.numpy as jnp

    from cvmatrix_tpu.models import sweep as S

    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    idx = np.arange(40).reshape(4, 10)
    wj = jnp.asarray(WEIGHTS)
    p1 = float(materialize_cv(cfg, X_ALL, Y_ALL, wj, idx))
    assert S._weights_validated(wj)
    p2 = float(materialize_cv(cfg, X_ALL, Y_ALL, wj, idx))
    p3 = float(materialize_cv(cfg, X_ALL, Y_ALL, wj, idx, validate=False))
    assert p1 == p2 == p3


def test_reduce_sweep_cache_survives_fresh_lambdas():
    """A fresh-but-identical reduce_fn lambda per call must not recompile
    the sweep program (static args hash via HashableFn's code key)."""
    from cvmatrix_tpu.models import sweep as S

    cfg = CVConfig(True, True, True, True, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    idx = np.arange(24).reshape(4, 6)

    def call(scale):
        return cross_validate_reduce(
            cfg, st, idx,
            reduce_fn=lambda mats, stats: mats[0].trace() * scale,
            batch_size=2)

    # Isolate from other tests' entries: jit caches hold weakly-referenced
    # static args, so a GC between measurements can shrink the count and
    # make an exact-delta assertion flaky in the full suite (observed once
    # in the 340-test run). GC stays OFF for the whole measurement window.
    import gc

    # Pin the MECHANISM first (jax-internals-free): the static-arg key for
    # fresh-but-identical lambdas must compare/hash equal, and a different
    # closure value must produce a different key.
    def make(scale):
        return S._HashableFn(lambda mats, stats: mats[0].trace() * scale)

    k1, k2, k3 = make(1.0), make(1.0), make(2.0)
    assert k1 == k2 and hash(k1) == hash(k2)
    assert k1 != k3

    S._reduce_sweep_jit.clear_cache()
    gc.collect()
    gc.disable()
    try:
        a = call(1.0)
        n0 = S._reduce_sweep_jit._cache_size()
        b = call(1.0)  # fresh lambda, same code + closure -> cache hit
        nb = S._reduce_sweep_jit._cache_size()
        assert_allclose(np.asarray(a), np.asarray(b))
        c = call(2.0)  # different closure value -> different program
        nc = S._reduce_sweep_jit._cache_size()
        assert_allclose(np.asarray(c), 2.0 * np.asarray(a))
        # pjit's _cache_size() reports -1 once the function has caches
        # under more than one jax config state (other tests call the
        # module-level jit under different contexts in the full suite) —
        # the counter assertions only mean something when it counts.
        if min(n0, nb, nc) >= 0:
            assert nb == n0, "identical lambda recompiled the sweep"
            assert nc == n0 + 1, "different closure aliased a program"
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# Oracle lattice for the sweep drivers: every center/scale combination,       #
# weighted and unweighted, LOOCV and 5-fold, against the NumPy oracle.        #
# --------------------------------------------------------------------------- #

_LN, _LK, _LM = 40, 4, 2
_LX, _LY, _, _LW = make_dataset(n=_LN, k=_LK, m=_LM)


def _oracle_close(got, want):
    """The repo's 1e-8 contract, scaled by the oracle's magnitude."""
    want = np.asarray(want)
    atol = 1e-8 * max(1.0, float(np.abs(want).max()))
    assert_allclose(np.asarray(got), want, atol=atol, rtol=0)


@pytest.mark.parametrize("scheme", ["loocv", "5fold"])
@pytest.mark.parametrize("use_w", [False, True])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)),
                         ids=lambda f: "".join("T" if b else "F" for b in f))
def test_sweep_drivers_match_oracle(flags, use_w, scheme):
    """materialize_cv's probe and cross_validate_reduce's per-fold digest
    (xtx[0,0], xtx[K-1,K-1], xty[0,0], trace(xtx)) equal the oracle's."""
    import jax.numpy as jnp

    w = _LW if use_w else None
    if scheme == "loocv":
        idx = np.arange(_LN)[:, None]
        batch = 8  # 5 chunks: the probe reads fold 32, the last chunk's first
    else:
        idx = np.stack([np.where(np.arange(_LN) % 5 == f)[0]
                        for f in range(5)])
        batch = 2  # 3 chunks of 2 (fold 4 repeated): the probe reads fold 4
    probe_fold = idx.shape[0] - (idx.shape[0] % batch or batch)
    cfg = CVConfig(*flags, ddof=1, dtype=np.float64)
    oracle = NaiveOracle(*flags, ddof=1).fit(_LX, _LY, w)

    def oracle_mats(f):
        train = np.setdiff1d(np.arange(_LN), idx[f])
        (ox, oy), _ = oracle.training_XTX_XTY(train)
        return ox, oy

    probe = materialize_cv(cfg, _LX, _LY, w, idx, batch_size=batch)
    ox, oy = oracle_mats(probe_fold)
    _oracle_close(float(probe), ox[0, 0] + oy[0, 0])

    def digest(mats, stats):
        xtx, xty = mats
        return jnp.stack([xtx[0, 0], xtx[_LK - 1, _LK - 1], xty[0, 0],
                          jnp.trace(xtx)])

    st = fit(cfg, _LX, _LY, w)
    got = np.asarray(cross_validate_reduce(cfg, st, idx, reduce_fn=digest,
                                           batch_size=batch))
    assert got.shape == (idx.shape[0], 4)
    for f in range(idx.shape[0]):
        ox, oy = oracle_mats(f)
        _oracle_close(got[f], [ox[0, 0], ox[-1, -1], oy[0, 0], np.trace(ox)])
