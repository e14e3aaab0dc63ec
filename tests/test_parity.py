"""Differential tests: fast engine vs the naive NumPy oracle.

The core contract (mirrors the reference's strategy,
``tests/test_cvmatrix.py:539-575, 420-537``): for every fold, the fast
engine's downdated training matrices and statistics must match a from-scratch
recompute at atol 1e-8, across the full flag lattice —
16 center/scale combinations x {no weights, random weights with zeros}
x ddof in {0, 1} x {Y present, Y absent}.
"""

from itertools import product

import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVMatrix, Partitioner

from .data import make_dataset, train_indices, zero_fraction
from .oracle import NaiveOracle

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset()

ATOL = 1e-8


def check_stats(fast_stats, naive_stats, msg=""):
    """Compare stats where both sides computed them.

    The fast engine's stat gating intentionally differs from the naive
    oracle's (e.g. scale-only folds never *return* the mean from the matrix
    methods — reference rule at cvmatrix/cvmatrix.py:828-831 vs the naive
    oracle returning it), so None pairs are skipped, exactly as the
    reference's check_equivalent_stats does (ref tests/test_cvmatrix.py:415-418).
    The fast engine's own gating is asserted in test_api.py.
    """
    assert len(fast_stats) == 4 and len(naive_stats) == 4
    for f, n in zip(fast_stats, naive_stats):
        if f is None or n is None:
            continue
        assert_allclose(np.asarray(f), n, atol=ATOL, err_msg=msg)


def check_fold_equivalence(fast: CVMatrix, naive: NaiveOracle, p: Partitioner,
                           msg="", max_folds=None):
    for i, fold in enumerate(p.folds_dict):
        if max_folds is not None and i == max_folds:
            break
        vi = p.get_validation_indices(fold)
        ti = train_indices(p.folds_dict, fold)
        if naive.Y is not None:
            (fx, fy), fs = fast.training_XTX_XTY(vi)
            (nx, ny), ns = naive.training_XTX_XTY(ti)
            assert_allclose(np.asarray(fx), nx, atol=ATOL, err_msg=msg)
            assert_allclose(np.asarray(fy), ny, atol=ATOL, err_msg=msg)
            check_stats(fs, ns, msg)
            # Single-matrix methods must agree with the combined method.
            dx, dxs = fast.training_XTX(vi)
            dy, dys = fast.training_XTY(vi)
            assert_allclose(np.asarray(dx), np.asarray(fx), atol=ATOL)
            assert_allclose(np.asarray(dy), np.asarray(fy), atol=ATOL)
            ndx, ndxs = naive.training_XTX(ti)
            ndy, ndys = naive.training_XTY(ti)
            assert_allclose(np.asarray(dx), ndx, atol=ATOL, err_msg=msg)
            assert_allclose(np.asarray(dy), ndy, atol=ATOL, err_msg=msg)
            check_stats(dxs, ndxs, msg)
            check_stats(dys, ndys, msg)
        else:
            fx, fs = fast.training_XTX(vi)
            nx, ns = naive.training_XTX(ti)
            assert_allclose(np.asarray(fx), nx, atol=ATOL, err_msg=msg)
            check_stats(fs, ns, msg)


@pytest.mark.parametrize("use_w", [False, True])
@pytest.mark.parametrize("use_Y", [False, True])
def test_all_preprocessing_combinations(use_w, use_Y):
    """The 16-combo lattice (ref test_cvmatrix.py:539-575)."""
    X = X_ALL[:, :5]
    Y = Y_ALL if use_Y else None
    p = Partitioner(FOLDS)
    for cx, cy, sx, sy, ddof in product(
        [False, True], [False, True], [False, True], [False, True], [0, 1]
    ):
        w = zero_fraction(WEIGHTS) if use_w else None
        msg = f"cx={cx} cy={cy} sx={sx} sy={sy} ddof={ddof} w={use_w} Y={use_Y}"
        fast = CVMatrix(cx, cy, sx, sy, ddof).fit(X, Y, w)
        naive = NaiveOracle(cx, cy, sx, sy, ddof).fit(X, Y, w)
        check_fold_equivalence(fast, naive, p, msg)


def test_loocv():
    """LOOCV equivalence on a subset of folds (ref :1357-1396)."""
    X = X_ALL[:60, :5]
    Y = Y_ALL[:60]
    w = zero_fraction(WEIGHTS[:60])
    folds = np.arange(60)
    p = Partitioner(folds)
    for cx, cy, sx, sy in [(True,) * 4, (False,) * 4, (True, True, False, False)]:
        fast = CVMatrix(cx, cy, sx, sy, 1).fit(X, Y, w)
        naive = NaiveOracle(cx, cy, sx, sy, 1).fit(X, Y, w)
        check_fold_equivalence(fast, naive, p, max_folds=12)


def test_ones_weights_equals_unweighted():
    """Unit weights must reproduce the unweighted path (ref :978-1018)."""
    X, Y = X_ALL[:, :5], Y_ALL
    p = Partitioner(FOLDS)
    fast_w = CVMatrix().fit(X, Y, np.ones(X.shape[0]))
    naive_unw = NaiveOracle().fit(X, Y, None)
    check_fold_equivalence(fast_w, naive_unw, p)
    fast_unw = CVMatrix().fit(X, Y, None)
    naive_w = NaiveOracle().fit(X, Y, np.ones(X.shape[0]))
    check_fold_equivalence(fast_unw, naive_w, p)


def test_constant_columns_std_clamp():
    """Constant columns hit the std<=resolution -> 1 clamp (ref :1045-1081)."""
    X = X_ALL[:, :5].copy()
    Y = Y_ALL.copy()
    X[:, 0] = 1.0
    Y[:, 0] = 1.0
    p = Partitioner(FOLDS)
    fast = CVMatrix(False, False, True, True, 1).fit(X, Y, WEIGHTS)
    naive = NaiveOracle(False, False, True, True, 1).fit(X, Y, WEIGHTS)
    check_fold_equivalence(fast, naive, p)


def test_one_dimensional_inputs():
    """1-D X/Y/weights are promoted to columns (ref :1083-1126)."""
    X = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    Y = np.array([5.0, 4.0, 3.0, 2.0, 1.0])
    w = np.array([2.0, 4.0, 6.0, 8.0, 10.0])
    folds = np.array([0, 0, 1, 1, 2])
    p = Partitioner(folds)
    fast = CVMatrix().fit(X, Y, w)
    naive = NaiveOracle().fit(X, Y, w)
    check_fold_equivalence(fast, naive, p)
    fast2 = CVMatrix().fit(X[:, None], Y[:, None], w[:, None])
    for fold in p.folds_dict:
        vi = p.get_validation_indices(fold)
        (a1, b1), _ = fast.training_XTX_XTY(vi)
        (a2, b2), _ = fast2.training_XTX_XTY(vi)
        assert_allclose(np.asarray(a1), np.asarray(a2))
        assert_allclose(np.asarray(b1), np.asarray(b2))


def test_val_fold_all_zero_weights():
    """A fold whose own weights are all zero still works (ref :949-976)."""
    w = WEIGHTS.copy()
    w[FOLDS == 0] = 0.0
    X, Y = X_ALL[:, :5], Y_ALL
    p = Partitioner(FOLDS)
    fast = CVMatrix().fit(X, Y, w)
    naive = NaiveOracle().fit(X, Y, w)
    check_fold_equivalence(fast, naive, p)


def test_refit_overwrites_state():
    """Refitting with swapped data matches a fresh model (ref :1020-1043)."""
    X = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    Y = np.array([5.0, 4.0, 3.0, 2.0, 1.0])
    w = np.array([17.0, 19.0, 23.0, 29.0, 31.0])
    folds = np.array([0, 0, 1, 1, 2])
    p = Partitioner(folds)
    fast = CVMatrix().fit(X, Y, w)
    naive = NaiveOracle().fit(X, Y, w)
    check_fold_equivalence(fast, naive, p)
    fast.fit(Y, X, None)
    naive2 = NaiveOracle().fit(Y, X, None)
    check_fold_equivalence(fast, naive2, p)


def test_hadamard_equals_diag_weight_matmul():
    """Hadamard weighting == diag(w) matmul in the oracle (ref :685-744),
    and the fast engine agrees with both."""
    X, Y = X_ALL[:100, :5], Y_ALL[:100]
    w = WEIGHTS[:100]
    p = Partitioner(FOLDS[:100])
    fast = CVMatrix().fit(X, Y, w)
    had = NaiveOracle(fast_weight_computation=True).fit(X, Y, w)
    diag = NaiveOracle(fast_weight_computation=False).fit(X, Y, w)
    for fold in p.folds_dict:
        ti = train_indices(p.folds_dict, fold)
        (hx, hy), _ = had.training_XTX_XTY(ti)
        (dx, dy), _ = diag.training_XTX_XTY(ti)
        assert_allclose(hx, dx, atol=ATOL)
        assert_allclose(hy, dy, atol=ATOL)
        (fx, fy), _ = fast.training_XTX_XTY(p.get_validation_indices(fold))
        assert_allclose(np.asarray(fx), dx, atol=ATOL)
        assert_allclose(np.asarray(fy), dy, atol=ATOL)


def test_exact_matmul_mode_matches_native_on_cpu():
    """matmul_mode='exact' (the int8-slice path) agrees with native f64."""
    X, Y = X_ALL[:, :5], Y_ALL
    p = Partitioner(FOLDS)
    exact = CVMatrix(matmul_mode="exact").fit(X, Y, WEIGHTS)
    native = CVMatrix(matmul_mode="native").fit(X, Y, WEIGHTS)
    for fold in p.folds_dict:
        vi = p.get_validation_indices(fold)
        (ex, ey), _ = exact.training_XTX_XTY(vi)
        (nx, ny), _ = native.training_XTX_XTY(vi)
        assert_allclose(np.asarray(ex), np.asarray(nx), rtol=1e-12, atol=1e-12)
        assert_allclose(np.asarray(ey), np.asarray(ny), rtol=1e-12, atol=1e-12)


def test_fold_syrk_route_matches_native(monkeypatch):
    """Wide-K fold downdates ride the SYRK contraction (like the fit); with
    the width gate lowered to test scale, the routed result still matches
    native f64 and the route is actually taken."""
    from cvmatrix_tpu.ops import precise as PR

    calls = {"n": 0}
    real = PR.symmetric_contract

    def spy(a, b, k, **kw):
        calls["n"] += 1
        return real(a, b, k, **kw)

    monkeypatch.setattr(PR, "_SYRK_MIN_K", 4)
    monkeypatch.setattr(PR, "symmetric_contract", spy)
    X, Y = X_ALL[:80, :6], Y_ALL[:80]
    p = Partitioner(FOLDS[:80])
    exact = CVMatrix(matmul_mode="exact").fit(X, Y, WEIGHTS[:80])
    native = CVMatrix(matmul_mode="native").fit(X, Y, WEIGHTS[:80])
    n_after_fit = calls["n"]  # the fit itself routes through SYRK
    fold = next(iter(p.folds_dict))
    vi = p.get_validation_indices(fold)
    (ex, ey), _ = exact.training_XTX_XTY(vi)
    (nx, ny), _ = native.training_XTX_XTY(vi)
    assert calls["n"] > n_after_fit  # FOLD downdate routed through SYRK
    assert_allclose(np.asarray(ex), np.asarray(nx), rtol=1e-12, atol=1e-12)
    assert_allclose(np.asarray(ey), np.asarray(ny), rtol=1e-12, atol=1e-12)
    ex = np.asarray(ex)
    assert_allclose(ex, ex.T, rtol=0, atol=1e-12)  # mirrored block coherent

    xtx_only, _ = exact.training_XTX(vi)
    nxtx, _ = native.training_XTX(vi)
    assert_allclose(np.asarray(xtx_only), nxtx, rtol=1e-12, atol=1e-12)
