"""Differential tests at the reference dataset's real scale.

The reference runs its entire equivalence suite on a 26617x102 NIR dataset
(ref ``tests/test_cvmatrix.py:48-49, 544``); round 1 only exercised a
600x8x2 synthetic. These tests run the 16-combo lattice on a deterministic
26617x102x10 NIR-like synthetic (same structure: absorbance spectra,
10 targets, 3 unequal natural folds — see ``tests/data.py``) and a K=500
LOOCV slice, so K >= 100 shapes are covered by the correctness suite on CPU,
not just by the benchmarks.
"""

from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVMatrix, Partitioner

from .data import nir_dataset, train_indices, zero_fraction
from .oracle import NaiveOracle

# Full 16-combo lattice at NIR-dataset scale; the fast PR loop keeps the
# same lattice at small N via tests/test_parity.py.
pytestmark = pytest.mark.slow

ATOL = 1e-8

# Real NIR grain data when CVMATRIX_TPU_NIR_CSV points at a local copy
# (see tests/data.py:load_real_nir), the deterministic synthetic analogue
# otherwise — the whole lattice below runs unchanged on either.
X_NIR, Y_NIR, SPLIT, W_NIR = nir_dataset()


def _check_fold(fast, naive, vi, ti, msg):
    (fx, fy), fs = fast.training_XTX_XTY(vi)
    (nx, ny), ns = naive.training_XTX_XTY(ti)
    assert_allclose(np.asarray(fx), nx, atol=ATOL, err_msg=msg)
    assert_allclose(np.asarray(fy), ny, atol=ATOL, err_msg=msg)
    for f, n in zip(fs, ns):
        if f is not None and n is not None:
            assert_allclose(np.asarray(f), n, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("use_w", [False, True])
def test_nir_scale_full_lattice(use_w):
    """All 16 center/scale combos on the 26617x102 natural-fold dataset."""
    w = zero_fraction(W_NIR) if use_w else None
    part = Partitioner(SPLIT)
    for cx, cy, sx, sy in product([False, True], repeat=4):
        msg = f"flags={(cx, cy, sx, sy)} weighted={use_w}"
        fast = CVMatrix(center_X=cx, center_Y=cy, scale_X=sx, scale_Y=sy,
                        ddof=1, dtype=np.float64)
        fast.fit(X_NIR, Y_NIR, weights=w)
        naive = NaiveOracle(center_X=cx, center_Y=cy, scale_X=sx, scale_Y=sy,
                            ddof=1)
        naive.fit(X_NIR, Y_NIR, weights=w)
        for fold in (0, 1, 2):
            _check_fold(fast, naive, part.get_validation_indices(fold),
                        train_indices(part.folds_dict, fold), msg)


@pytest.mark.parametrize("use_w", [False, True])
def test_k500_loocv_slice(use_w):
    """K=500 LOOCV: eager + jit(vmap) batch vs the oracle, subset of folds.

    The benchmark flagship shape (K=500) exercised by the correctness suite:
    N is trimmed (the downdate math is row-count independent) and only a
    handful of leave-one-out folds are checked against the naive recompute.
    """
    n, k, m = 3000, 500, 10
    rng = np.random.default_rng(11)
    # Widen the NIR-like spectra to K=500 by mixing channels.
    X = np.asarray(X_NIR[:n] @ rng.normal(size=(X_NIR.shape[1], k)) / 10.0)
    Y = np.asarray(Y_NIR[:n])
    w = zero_fraction(W_NIR[:n]) if use_w else None

    fast = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                    ddof=1, dtype=np.float64)
    fast.fit(X, Y, weights=w)
    naive = NaiveOracle(ddof=1)
    naive.fit(X, Y, weights=w)

    check = [0, 1, n // 2, n - 1]
    all_idx = np.arange(n)
    for i in check:
        vi = np.array([i])
        _check_fold(fast, naive, vi, np.delete(all_idx, i), f"loocv fold {i}")

    # Batched path: jit(vmap) over a block of folds must match eager.
    batch = jnp.arange(32)[:, None]
    (bx, by), _ = jax.jit(jax.vmap(fast.training_XTX_XTY))(batch)
    (ex, ey), _ = fast.training_XTX_XTY(np.array([5]))
    assert_allclose(np.asarray(bx[5]), np.asarray(ex), atol=ATOL)
    assert_allclose(np.asarray(by[5]), np.asarray(ey), atol=ATOL)
