"""Seeded differential fuzz: random scenarios vs the NumPy oracle.

The lattice suites (test_parity.py, test_realscale.py) pin the flag space at
a few fixed shapes; this sweep varies everything else — shape, fold
structure (uneven sizes, non-contiguous integer/string labels), weight
regimes (none / uniform / zero-heavy / tiny-magnitude), column conditioning
(constant columns, 1e±8 scale spreads) and dtype — under a fixed seed, so a
regression anywhere in the normalize -> fit -> downdate -> epilogue pipeline
that the fixed-shape suites happen to miss still trips a 1e-8 oracle
comparison. The reference has no analogue; its suite is fixed-shape
(ref tests/test_cvmatrix.py:539-575), so this strictly widens coverage.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVMatrix, Partitioner

from .data import train_indices
from .oracle import NaiveOracle

N_SCENARIOS = 24
# One seed per round (VERDICT r2 task 10): each round ADDS 24 fresh
# scenarios instead of re-checking the same ones; old seeds stay pinned
# so past coverage never regresses.
SEEDS = (20260817, 20260818)
SEED = SEEDS[0]  # non-parametrized helpers keep the round-2 seed


def _assert_close(fast_val, naive_val, msg):
    """1e-8 contract, scaled by the matrix's own magnitude.

    The reference's atol=1e-8 contract is stated for O(1)-scale data; the
    fuzz draws column scales up to 1e8, where XTX entries reach ~1e18 and
    f64 summation-order differences alone exceed 1e-8 absolute. Scaling
    the tolerance by max(1, |oracle|_max) keeps the contract exactly as
    strict at reference scale and meaningfully strict everywhere else."""
    n = np.asarray(naive_val)
    atol = 1e-8 * max(1.0, float(np.abs(n).max()))
    assert_allclose(np.asarray(fast_val), n, atol=atol, err_msg=msg)


def _check_folds(fast, naive, p, msg, max_folds=4):
    for i, fold in enumerate(p.folds_dict):
        if i == max_folds:
            break
        vi = p.get_validation_indices(fold)
        ti = train_indices(p.folds_dict, fold)
        if naive.Y is not None:
            (fx, fy), fs = fast.training_XTX_XTY(vi)
            (nx, ny), ns = naive.training_XTX_XTY(ti)
            _assert_close(fx, nx, msg)
            _assert_close(fy, ny, msg)
        else:
            fx, fs = fast.training_XTX(vi)
            nx, ns = naive.training_XTX(ti)
            _assert_close(fx, nx, msg)
        for f, n in zip(fs, ns):
            if f is None or n is None:  # stat gating differs by design
                continue
            _assert_close(f, n, msg)


def _scenario(rng: np.random.Generator):
    n = int(rng.integers(20, 300))
    k = int(rng.integers(1, 40))
    m = int(rng.integers(0, 7))
    X = rng.standard_normal((n, k))
    conditioning = rng.integers(0, 4)
    if conditioning == 1 and k >= 2:  # wild per-column scale spread
        X *= 10.0 ** rng.integers(-8, 9, size=(1, k))
    elif conditioning == 2:
        # Constant column: exercises the std<=resolution -> 1 clamp. The
        # constant must be a power of two: the one-pass downdated variance
        # (ref cvmatrix/cvmatrix.py:1081-1129, core/fold.py:_train_std)
        # cancels BIT-exactly only when scaling by c is exact, otherwise
        # either engine (ours and the reference's — same identity) leaves
        # eps * c^2 * n-grade noise whose sqrt lands ABOVE the absolute
        # resolution clamp, and a scaled constant column is then amplified
        # by ~1/noise — out of the 1e-8 oracle contract by construction.
        X[:, rng.integers(0, k)] = float(rng.choice([-4.0, -0.5, 1.0, 2.0]))
    Y = rng.standard_normal((n, m)) if m else None

    wmode = rng.integers(0, 4)
    if wmode == 0:
        w = None
    elif wmode == 1:
        w = rng.random(n) + 0.05
    elif wmode == 2:  # zero-heavy: nnz bookkeeping, fold nnz edge cases
        w = rng.random(n) * (rng.random(n) > 0.4)
        w[: max(3, n // 10)] += 0.5  # keep every fold's training nnz > ddof
    else:  # tiny magnitudes: sum_w cancellation
        w = (rng.random(n) + 0.1) * 1e-6

    n_folds = int(rng.integers(2, min(9, n // 4)))
    if rng.integers(0, 2):  # non-contiguous integer labels
        labels = rng.choice(np.arange(0, 1000, 7)[:n_folds], size=n)
    else:  # string labels, uneven sizes
        labels = np.array([f"fold_{i}" for i in
                           rng.integers(0, n_folds, size=n)])
    flags = tuple(bool(b) for b in rng.integers(0, 2, size=4))
    ddof = int(rng.integers(0, 2))
    return X, Y, w, labels, flags, ddof


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", range(N_SCENARIOS))
def test_random_scenarios_match_oracle(case, seed):
    rng = np.random.default_rng(seed + case)
    X, Y, w, labels, flags, ddof = _scenario(rng)
    p = Partitioner(labels)
    cx, cy, sx, sy = flags
    msg = (f"case={case} n={X.shape[0]} k={X.shape[1]} "
           f"m={0 if Y is None else Y.shape[1]} flags={flags} ddof={ddof} "
           f"w={'None' if w is None else 'arr'}")
    fast = CVMatrix(cx, cy, sx, sy, ddof).fit(X, Y, w)
    naive = NaiveOracle(cx, cy, sx, sy, ddof).fit(X, Y, w)
    _check_folds(fast, naive, p, msg)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", range(8))
def test_random_scenarios_batched_engine(case, seed):
    """The padded/masked batched engine on random uneven fold layouts must
    match the eager per-fold engine exactly-ish (same arithmetic modulo
    batching): random sizes exercise the zero-pad + mask math beyond the
    fixed lattice suites."""
    from cvmatrix_tpu.core.batch import training_matrices_batched
    from cvmatrix_tpu.core.fit import fit as fit_fn
    from cvmatrix_tpu.config import CVConfig

    rng = np.random.default_rng(seed + 1000 + case)
    X, Y, w, labels, flags, ddof = _scenario(rng)
    if Y is None:
        Y = rng.standard_normal((X.shape[0], 2))  # batched path needs Y here
    p = Partitioner(labels)
    keys, idx, mask = p.padded_batches()
    cfg = CVConfig(*flags, ddof=ddof, dtype=np.float64)
    st = fit_fn(cfg, X, Y, w)
    (bx, by), _ = training_matrices_batched(cfg, st, idx, mask)
    fast = CVMatrix(*flags, ddof).fit(X, Y, w)
    for i, key in enumerate(keys):
        vi = p.get_validation_indices(key)
        (ex, ey), _ = fast.training_XTX_XTY(vi)
        scale = max(1.0, float(np.abs(np.asarray(ex)).max()))
        assert_allclose(np.asarray(bx)[i], np.asarray(ex),
                        atol=1e-10 * scale, err_msg=f"case={case} fold={key}")
        assert_allclose(np.asarray(by)[i], np.asarray(ey),
                        atol=1e-10 * scale, err_msg=f"case={case} fold={key}")


def test_fuzz_float32_grade():
    """One f32 scenario: same pipeline, dtype-scaled tolerance (the 1e-8
    contract is f64-only; f32 holds ~1e-3 at these condition numbers)."""
    rng = np.random.default_rng(SEED - 1)
    X = rng.standard_normal((120, 12)).astype(np.float32)
    Y = rng.standard_normal((120, 3)).astype(np.float32)
    w = (rng.random(120) + 0.05).astype(np.float32)
    labels = rng.integers(0, 5, size=120)
    p = Partitioner(labels)
    fast = CVMatrix(True, True, True, True, 1, dtype=np.float32).fit(X, Y, w)
    naive = NaiveOracle(True, True, True, True, 1,
                        dtype=np.float64).fit(X, Y, w)
    for fold in list(p.folds_dict)[:3]:
        vi = p.get_validation_indices(fold)
        ti = train_indices(p.folds_dict, fold)
        (fx, fy), _ = fast.training_XTX_XTY(vi)
        (nx, ny), _ = naive.training_XTX_XTY(ti)
        scale = max(np.max(np.abs(nx)), 1.0)
        assert_allclose(np.asarray(fx, np.float64), nx,
                        atol=1e-3 * scale)
        assert_allclose(np.asarray(fy, np.float64), ny,
                        atol=1e-3 * scale)
