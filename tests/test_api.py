"""API-surface tests: errors, stat gating, statistics consistency, dtypes.

Covers the reference's error/degenerate axes (ref ``tests/test_cvmatrix.py``:
negative weights :746-783; ddof >= nnz :785-847; zero-weight training sets
:849-947; Y=None / both-flags-false / unknown fold :1252-1292; statistics
consistency across the four public methods :1294-1355; dtype preservation
:1147-1205).
"""

from itertools import product

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVConfig, CVMatrix, Partitioner

from .data import make_dataset, zero_fraction

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset()


def test_negative_weights_raise():
    with pytest.raises(ValueError, match="Weights must be non-negative."):
        CVMatrix().fit(X_ALL, Y_ALL, -WEIGHTS)


def test_y_none_and_flag_errors():
    fast = CVMatrix().fit(X_ALL[:, :4], None, WEIGHTS)
    p = Partitioner(FOLDS)
    vi = p.get_validation_indices(0)
    with pytest.raises(ValueError, match="Response variables `Y` are not provided."):
        fast.training_XTX_XTY(vi)
    with pytest.raises(ValueError, match="Response variables `Y` are not provided."):
        fast.training_XTY(vi)
    with pytest.raises(
        ValueError, match="At least one of `return_XTX` and `return_XTY`"
    ):
        fast._training_matrices(False, False, vi)


def test_unknown_fold():
    p = Partitioner(FOLDS)
    with pytest.raises(ValueError, match="Fold 9 not found."):
        p.get_validation_indices(9)


def test_invalid_backend():
    with pytest.raises(ValueError, match="Invalid backend"):
        CVMatrix(backend="torch")


def test_invalid_config():
    with pytest.raises(ValueError, match="floating"):
        CVConfig(dtype=np.int32)
    with pytest.raises(ValueError, match="matmul_mode"):
        CVConfig(matmul_mode="fast")


def test_ddof_geq_nonzero_weights_raises():
    """ddof >= training nnz must raise for std-computing configs (ref :785-847)."""
    n = X_ALL.shape[0]
    w = WEIGHTS.copy()
    w[2:] = 0.0  # only rows 0,1 carry weight
    folds = np.zeros(n, dtype=int)
    folds[:2] = 1  # validating fold 0 leaves a 2-nonzero-weight training set
    p = Partitioner(folds)
    vi = p.get_validation_indices(0)
    fast = CVMatrix(True, True, True, True, ddof=2).fit(X_ALL, Y_ALL, w)
    msg = "must be greater than `ddof`"
    with pytest.raises(ValueError, match=msg):
        fast.training_XTX_XTY(vi)
    with pytest.raises(ValueError, match=msg):
        fast.training_XTX(vi)
    with pytest.raises(ValueError, match=msg):
        fast.training_XTY(vi)
    # A config with no X-side stats must NOT raise from training_XTX
    # (ref :832-836: the check only runs when stats are requested).
    fast2 = CVMatrix(False, True, False, True, ddof=2).fit(X_ALL, Y_ALL, w)
    fast2.training_XTX(vi)  # no raise
    with pytest.raises(ValueError, match=msg):
        fast2.training_XTY(vi)


def test_all_train_weights_zero_raises():
    """Training sets with zero non-zero weights raise when stats needed (ref :849-947)."""
    w = WEIGHTS.copy()
    w[FOLDS != 0] = 0.0  # all weight lives in fold 0
    p = Partitioner(FOLDS)
    vi = p.get_validation_indices(0)
    msg = "must be greater than zero"
    for cx, cy, sx, sy in product([False, True], repeat=4):
        if not (cx or cy or sx or sy):
            continue
        fast = CVMatrix(cx, cy, sx, sy, ddof=0).fit(X_ALL, Y_ALL, w)
        with pytest.raises(ValueError, match=msg):
            fast.training_XTX_XTY(vi)
        if cx or sx:
            with pytest.raises(ValueError, match=msg):
                fast.training_XTX(vi)
        else:
            fast.training_XTX(vi)  # no X-side stats -> no raise
        with pytest.raises(ValueError, match=msg):
            fast.training_XTY(vi)
    # No preprocessing at all: never raises (ref test_train_zeros_weights).
    fast = CVMatrix(False, False, False, False, ddof=0).fit(X_ALL, Y_ALL, w)
    fast.training_XTX_XTY(vi)


def test_stat_gating():
    """Exact None/not-None pattern of the returned stats tuple (ref :828-831)."""
    p = Partitioner(FOLDS)
    vi = p.get_validation_indices(0)
    for cx, cy, sx, sy in product([False, True], repeat=4):
        fast = CVMatrix(cx, cy, sx, sy, ddof=1).fit(X_ALL, Y_ALL, WEIGHTS)
        _, (xm, xs, ym, ys) = fast.training_XTX_XTY(vi)
        assert (xm is not None) == (cx or cy)
        assert (xs is not None) == sx
        assert (ym is not None) == (cx or cy)
        assert (ys is not None) == sy
        _, (xm, xs, ym, ys) = fast.training_XTX(vi)
        assert (xm is not None) == cx
        assert (xs is not None) == sx
        assert ym is None and ys is None
        # training_statistics uses its own flag set (ref :570-573).
        xm, xs, ym, ys = fast.training_statistics(vi)
        assert (xm is not None) == (cx or sx)
        assert (xs is not None) == sx
        assert (ym is not None) == (cy or sy)
        assert (ys is not None) == sy


def test_statistics_consistent_across_methods():
    """Stats from the 4 public methods agree where computed (ref :1294-1355)."""
    p = Partitioner(FOLDS)
    X = X_ALL[:, :5]
    for cx, cy, sx, sy, use_w, ddof, Y in product(
        [False, True], [False, True], [False, True], [False, True],
        [False, True], [0, 1], [None, Y_ALL],
    ):
        w = zero_fraction(WEIGHTS) if use_w else None
        fast = CVMatrix(cx, cy, sx, sy, ddof).fit(X, Y, w)
        for vi in p.folds_dict.values():
            ref_stats = fast.training_statistics(vi)
            others = [fast.training_XTX(vi)[1]]
            if Y is not None:
                others.append(fast.training_XTX_XTY(vi)[1])
                others.append(fast.training_XTY(vi)[1])
            for st in others:
                for a, b in zip(ref_stats, st):
                    if a is None or b is None:
                        continue
                    assert_allclose(np.asarray(a), np.asarray(b), atol=1e-8)


def test_dtype_preservation():
    """float32/float64 in -> same dtype out (ref :1147-1205; jax dtypes only)."""
    X = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    Y = np.array([5.0, 4.0, 3.0, 2.0, 1.0])
    w = np.array([3.0, 6.0, 9.0, 12.0, 15.0])
    folds = np.array([0, 0, 1, 1, 2])
    p = Partitioner(folds)
    for dtype in (np.float32, np.float64):
        for use_w in (False, True):
            fast = CVMatrix(True, True, True, True, 1, dtype).fit(
                X, Y, w if use_w else None
            )
            (a, b), stats = fast.training_XTX_XTY(p.get_validation_indices(0))
            assert a.dtype == dtype and b.dtype == dtype
            for s in stats:
                if s is not None:
                    assert s.dtype == dtype


def test_trace_defers_degenerate_check():
    """Eager degenerate folds raise; under jit tracing they must not (ref :654-683)."""
    X = X_ALL[:6, :4]
    Y = Y_ALL[:6]
    cvm = CVMatrix(True, True, True, True, ddof=1).fit(X, Y, None)
    degenerate = np.arange(5)  # leaves 1 training row <= ddof
    with pytest.raises(ValueError, match="greater than `ddof`"):
        cvm.training_XTX_XTY(degenerate)
    (xtx, _), _ = jax.jit(cvm.training_XTX_XTY)(jnp.asarray(degenerate))
    assert xtx.shape == (4, 4)
    # vmap without jit also traces (BatchTracer) and must not raise.
    (xtxb, _), _ = jax.vmap(cvm.training_XTX_XTY)(jnp.asarray(degenerate)[None])
    assert xtxb.shape == (1, 4, 4)


def test_preflight_rejects_degenerate_folds():
    """Host-side pre-flight (the deferred-check counterpart)."""
    n = X_ALL.shape[0]
    w = WEIGHTS.copy()
    w[FOLDS != 0] = 0.0
    p = Partitioner(FOLDS)
    with pytest.raises(ValueError, match="greater than zero"):
        p.validate(n, w, ddof=0, needs_stats=True)
    p.validate(n, WEIGHTS, ddof=1, needs_stats=True, needs_std=True)  # fine
    bad = Partitioner(np.arange(4))
    with pytest.raises(ValueError, match="outside"):
        bad.folds_dict[0][:] = 99
        bad.validate(4)


def test_cvmatrix_pickles():
    """Picklability is a stated reference design constraint
    (ref partitioner.py:26-31: CVMatrix must pickle cheaply so downstream
    packages can fan folds out across processes)."""
    import pickle

    from .data import make_dataset

    X, Y, FOLDS, W = make_dataset(n=60, k=4, m=2)
    cvm = CVMatrix(True, True, True, True, ddof=1).fit(X, Y, W)
    clone = pickle.loads(pickle.dumps(cvm))
    p = Partitioner(FOLDS)
    vi = p.get_validation_indices(0)
    (a, b), _ = cvm.training_XTX_XTY(vi)
    (a2, b2), _ = clone.training_XTX_XTY(vi)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(b2))
    # Partitioner pickles independently (detached from the engine)
    p2 = pickle.loads(pickle.dumps(p))
    np.testing.assert_array_equal(p2.get_validation_indices(0), vi)


def test_float16_dtype():
    """f16 engine runs end-to-end (reference tests f16 on numpy; here the
    JAX engine computes in f16 with the loose tolerance that implies)."""
    from .data import make_dataset
    from .oracle import NaiveOracle

    X, Y, FOLDS, W = make_dataset(n=80, k=4, m=2)
    cfg_kw = dict(ddof=1, dtype=np.float16)
    cvm = CVMatrix(False, False, False, False, **cfg_kw).fit(X, Y, None)
    p = Partitioner(FOLDS)
    vi = p.get_validation_indices(0)
    (a, b), _ = cvm.training_XTX_XTY(vi)
    assert np.asarray(a).dtype == np.float16
    naive = NaiveOracle(False, False, False, False, ddof=1,
                        dtype=np.float64).fit(X, Y, None)
    ti = np.setdiff1d(np.arange(X.shape[0]), vi)
    (na, nb), _ = naive.training_XTX_XTY(ti)
    # f16 has ~3 decimal digits; magnitudes here are O(40)
    np.testing.assert_allclose(np.asarray(a, np.float64), na, rtol=0.15)


def test_enable_persistent_cache(tmp_path, monkeypatch):
    """Cache helper sets the JAX knobs and creates the directory."""
    import jax

    from cvmatrix_tpu.utils import enable_persistent_cache

    d = str(tmp_path / "xla-cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    try:
        got = enable_persistent_cache()
        assert got == d
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        jax.config.update("jax_compilation_cache_dir", None)


@pytest.mark.parametrize("case", ["env_set", "env_unset", "second_call"])
def test_persistent_cache_location(tmp_path, monkeypatch, case):
    """JAX_COMPILATION_CACHE_DIR wins when set and no other directory is
    configured; unset, the cache lives at one fixed path inside the
    checkout, the same on every call."""
    import jax

    from cvmatrix_tpu.utils import enable_persistent_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixed = os.path.join(repo, ".jax_cache")
    try:
        if case == "env_set":
            d = str(tmp_path / "from-env")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
            assert enable_persistent_cache() == d
            assert jax.config.jax_compilation_cache_dir == d
            assert os.listdir(tmp_path) == ["from-env"]
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            first = enable_persistent_cache()
            assert first == fixed and os.path.isdir(fixed)
            assert jax.config.jax_compilation_cache_dir == fixed
            if case == "second_call":
                assert enable_persistent_cache() == first
    finally:
        jax.config.update("jax_compilation_cache_dir", None)


def test_masked_fold_keeps_config_dtype():
    """padded_batches builds f64 masks; the fold math must cast them to the
    config dtype instead of silently promoting an f32 job to f64
    (round-3 review finding)."""
    import jax.numpy as jnp

    cfg32 = CVMatrix(True, True, True, True, 1, dtype=np.float32)
    X = X_ALL[:40].astype(np.float32)
    Y = Y_ALL[:40].astype(np.float32)
    cfg32.fit(X, Y, None)
    p = Partitioner(np.array([0] * 15 + [1] * 25))
    keys, idx, mask = p.padded_batches()
    assert np.asarray(mask).dtype == np.float64  # the hazard input
    (xtx, xty), _ = cfg32.training_XTX_XTY(idx[0], mask[0])
    assert jnp.asarray(xtx).dtype == jnp.float32
    assert jnp.asarray(xty).dtype == jnp.float32
