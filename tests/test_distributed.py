"""Multi-device correctness on the 8-device virtual CPU mesh.

The reference has no distributed layer (SURVEY.md §2); the contract here is
*agreement*: row-sharded fit + mesh fold computation must match the
single-device engine (which in turn matches the NumPy oracle) at 1e-8.
"""

import jax
import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVConfig, CVMatrix, Partitioner, fit
from cvmatrix_tpu.parallel.distributed import (
    fit_sharded,
    make_mesh,
    sharded_training_matrices,
)

from .data import make_dataset, zero_fraction

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh()


@pytest.mark.parametrize("use_w", [False, True])
def test_sharded_fit_matches_single_device(mesh, use_w):
    w = zero_fraction(WEIGHTS) if use_w else None
    cfg = CVConfig(True, True, True, True, 1)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, w)
    ref = CVMatrix().fit(X_ALL, Y_ALL, w)
    assert_allclose(np.asarray(st.XTX), np.asarray(ref.XTX), atol=1e-9)
    assert_allclose(np.asarray(st.XTY), np.asarray(ref.XTY), atol=1e-9)
    assert_allclose(np.asarray(st.sum_X), np.asarray(ref.sum_X), atol=1e-10)
    assert_allclose(np.asarray(st.sum_sq_X), np.asarray(ref.sum_sq_X), atol=1e-10)
    assert float(st.sum_w) == pytest.approx(float(ref.sum_w))
    # Row padding to the shard count must not change any statistic.
    assert st.X.shape[0] % 8 == 0


@pytest.mark.parametrize("use_w", [False, True])
@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, False, False, False),
                                   (True, False, False, True)])
def test_sharded_folds_match_single_device(mesh, use_w, flags):
    cx, cy, sx, sy = flags
    w = zero_fraction(WEIGHTS) if use_w else None
    cfg = CVConfig(cx, cy, sx, sy, 1)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, w)
    ref = CVMatrix(cx, cy, sx, sy, 1).fit(X_ALL, Y_ALL, w)
    p = Partitioner(FOLDS)
    keys, idx, mask = p.padded_batches()
    (xtx_b, xty_b), stats_b = sharded_training_matrices(
        cfg, st, idx, mask, mesh=mesh
    )
    for i, k in enumerate(keys):
        (xtx, xty), stats = ref.training_XTX_XTY(p.get_validation_indices(k))
        assert_allclose(np.asarray(xtx_b[i]), np.asarray(xtx), atol=1e-8)
        assert_allclose(np.asarray(xty_b[i]), np.asarray(xty), atol=1e-8)
        for sb, s in zip(stats_b, stats):
            if s is None:
                assert sb is None
            else:
                assert_allclose(np.asarray(sb[i]), np.asarray(s), atol=1e-8)


def test_sharded_xtx_only(mesh):
    cfg = CVConfig(True, True, True, True, 1)
    st = fit_sharded(cfg, mesh, X_ALL, None, WEIGHTS)
    ref = CVMatrix().fit(X_ALL, None, WEIGHTS)
    p = Partitioner(FOLDS)
    keys, idx, mask = p.padded_batches()
    xtx_b, _ = sharded_training_matrices(
        cfg, st, idx, mask, mesh=mesh, return_XTY=False
    )
    for i, k in enumerate(keys):
        xtx, _ = ref.training_XTX(p.get_validation_indices(k))
        assert_allclose(np.asarray(xtx_b[i]), np.asarray(xtx), atol=1e-8)


def test_sharded_y_none_error(mesh):
    cfg = CVConfig()
    st = fit_sharded(cfg, mesh, X_ALL, None, None)
    p = Partitioner(FOLDS)
    _, idx, mask = p.padded_batches()
    with pytest.raises(ValueError, match="Response variables"):
        sharded_training_matrices(cfg, st, idx, mask, mesh=mesh)


def test_sharded_negative_weights(mesh):
    with pytest.raises(ValueError, match="non-negative"):
        fit_sharded(CVConfig(), mesh, X_ALL, Y_ALL, -WEIGHTS)


def test_multihost_single_process_degenerates(mesh):
    """multihost helpers: single-process path == plain sharded fit."""
    from cvmatrix_tpu.parallel import multihost

    multihost.initialize()  # no coordinator: must no-op, not raise
    gm = multihost.global_mesh()
    assert gm.devices.size == len(jax.devices())

    n = 83
    start, stop = multihost.host_row_slice(n, gm)
    assert start == 0 and stop == n  # one process owns every row

    cfg = CVConfig(True, True, True, True, ddof=1)
    X, Y, w = X_ALL[:n, :5], Y_ALL[:n], WEIGHTS[:n]
    st_mh = multihost.fit_sharded_multihost(cfg, gm, X, Y, w)
    st = fit(cfg, X, Y, w)
    assert_allclose(np.asarray(st_mh.XTX), np.asarray(st.XTX), atol=1e-10)
    assert_allclose(np.asarray(st_mh.XTY), np.asarray(st.XTY), atol=1e-10)

def test_sharded_untrimmed_keeps_fold_sharding(mesh):
    """trim_padding=False: padded results stay evenly fold-sharded."""
    cfg = CVConfig(True, True, True, True, 1)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, WEIGHTS)
    idx = np.arange(11)[:, None]  # 11 folds on an 8-device mesh -> pad to 16
    (trimmed, _), _ = sharded_training_matrices(cfg, st, idx, mesh=mesh)
    ((xtx_p, xty_p), _), n = sharded_training_matrices(
        cfg, st, idx, mesh=mesh, trim_padding=False
    )
    assert n == 11 and xtx_p.shape[0] == 16
    # still sharded over folds: each device holds 16/8 = 2 folds
    shard_shapes = {s.data.shape[0] for s in xtx_p.addressable_shards}
    assert shard_shapes == {2}
    assert_allclose(np.asarray(xtx_p[:n]), np.asarray(trimmed), atol=0)
    # padded tail duplicates fold 0
    assert_allclose(np.asarray(xtx_p[n]), np.asarray(xtx_p[0]), atol=0)


from cvmatrix_tpu.parallel.distributed import sharded_cross_validate_reduce


def test_sharded_reduce(mesh):
    """Single-program mesh sweep with on-device reduction."""
    import jax.numpy as jnp

    cfg = CVConfig(True, True, True, True, 1)
    w = zero_fraction(WEIGHTS)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, w)
    ref = CVMatrix().fit(X_ALL, Y_ALL, w)
    n_folds = 37  # not a multiple of the chunk or mesh size
    idx = np.arange(n_folds)[:, None]

    def reduce_fn(mats, stats):
        xtx, xty = mats
        return jnp.trace(xtx) + jnp.sum(xty)

    red = sharded_cross_validate_reduce(
        cfg, st, idx, mesh=mesh, reduce_fn=reduce_fn, batch_size=16,
    )
    assert red.shape == (n_folds,)
    for i in (0, 17, n_folds - 1):
        (xtx, xty), _ = ref.training_XTX_XTY(np.array([i]))
        want = float(np.trace(np.asarray(xtx)) + np.sum(np.asarray(xty)))
        assert abs(float(red[i]) - want) < 1e-8 * max(1.0, abs(want))


def test_sharded_programs_are_cached(mesh):
    """Repeat sharded calls reuse the compiled programs (no per-call jit).

    A fresh ``jax.jit`` wrapper per invocation recompiles the whole mesh
    program every call (measured 130x slowdown on the warm path before the
    ``lru_cache`` builders landed); this pins the cache behaviour.
    """
    import jax.numpy as jnp

    from cvmatrix_tpu.parallel import distributed as D

    cfg = CVConfig(True, False, True, False, 1)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, WEIGHTS)
    idx = np.arange(12)[:, None]

    def reduce_fn(mats, stats):
        return jnp.trace(mats[0])

    h0 = D._reduce_program_cached.cache_info().hits
    g0 = D._gather_program.cache_info().hits
    f0 = D._fold_math_program.cache_info().hits
    for _ in range(2):
        red = sharded_cross_validate_reduce(
            cfg, st, idx, mesh=mesh, reduce_fn=reduce_fn)
        out = sharded_training_matrices(cfg, st, idx, mesh=mesh)
    assert D._reduce_program_cached.cache_info().hits > h0
    assert D._gather_program.cache_info().hits > g0
    assert D._fold_math_program.cache_info().hits > f0
    assert red.shape == (12,)


def test_reduce_program_cache_survives_fresh_lambdas(mesh):
    """A fresh-but-identical lambda per call (the natural caller style)
    still hits the program cache: the key is the code object + closure
    values, not function identity (advisor round-2 finding)."""
    import jax.numpy as jnp

    from cvmatrix_tpu.parallel import distributed as D

    cfg = CVConfig(False, True, False, True, 1)
    st = fit_sharded(cfg, mesh, X_ALL, Y_ALL, WEIGHTS)
    idx = np.arange(12)[:, None]

    def call(scale):
        return sharded_cross_validate_reduce(
            cfg, st, idx, mesh=mesh,
            reduce_fn=lambda mats, stats: jnp.trace(mats[0]) * scale)

    m0 = D._reduce_program_cached.cache_info().misses
    a = call(1.0)
    misses_after_first = D._reduce_program_cached.cache_info().misses
    b = call(1.0)  # fresh lambda, same code + same closure value
    assert D._reduce_program_cached.cache_info().misses == misses_after_first
    assert misses_after_first == m0 + 1
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # a DIFFERENT closure value must be a different program, not an alias
    c = call(2.0)
    assert D._reduce_program_cached.cache_info().misses == misses_after_first + 1
    np.testing.assert_allclose(np.asarray(c), 2.0 * np.asarray(a))


@pytest.mark.parametrize("use_w", [False, True])
@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, False, False, False),
                                   (True, False, False, True),
                                   (False, True, True, False)],
                         ids=lambda f: "".join("T" if b else "F" for b in f))
def test_mesh_reduce_matches_one_device(mesh, flags, use_w):
    """The 8-device mesh sweep agrees with the one-device sweep on uneven
    (padded + masked) folds and on LOOCV, per fold, at 1e-8."""
    import jax.numpy as jnp

    from cvmatrix_tpu.models.sweep import cross_validate_reduce

    cfg = CVConfig(*flags, 1)
    w = zero_fraction(WEIGHTS) if use_w else None
    st_mesh = fit_sharded(cfg, mesh, X_ALL, Y_ALL, w)
    st_one = fit(cfg, X_ALL, Y_ALL, w)

    def digest(mats, stats):
        xtx, xty = mats
        return jnp.stack([xtx[0, 0], xtx[-1, -1], xty[0, 0], jnp.trace(xtx)])

    _, idx, mask = Partitioner(FOLDS).padded_batches()
    for idx_b, mask_b in ((idx, mask), (np.arange(29)[:, None], None)):
        got = sharded_cross_validate_reduce(
            cfg, st_mesh, idx_b, mask_b, mesh=mesh, reduce_fn=digest,
            batch_size=16)
        want = np.asarray(cross_validate_reduce(
            cfg, st_one, idx_b, mask_b, reduce_fn=digest, batch_size=16))
        scale = max(1.0, float(np.abs(want).max()))
        assert_allclose(np.asarray(got), want, atol=1e-8 * scale, rtol=0)
