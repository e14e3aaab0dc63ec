"""Accuracy contract of the precise contraction ops (native and exact modes)."""

import jax
import jax.numpy as jnp
import numpy as np

import pytest

from cvmatrix_tpu.ops.precise import (
    _pow2,
    contract,
    outer_accumulate_contract,
    ozaki_contract,
    symmetric_contract,
)


def _relerr(got, ref):
    return np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30))


def test_ozaki_well_conditioned():
    rng = np.random.default_rng(0)
    a = rng.random((5000, 64))
    b = rng.random((5000, 33))
    got = np.asarray(jax.jit(ozaki_contract)(jnp.asarray(a), jnp.asarray(b)))
    assert _relerr(got, a.T @ b) < 1e-13


def test_ozaki_wide_dynamic_range():
    rng = np.random.default_rng(1)
    a = rng.random((2048, 40)) * rng.lognormal(0, 4, (2048, 40))
    b = rng.random((2048, 16)) * np.exp(rng.normal(0, 5, (2048, 16)))
    ref = a.T @ b
    got = np.asarray(jax.jit(ozaki_contract)(jnp.asarray(a), jnp.asarray(b)))
    # Column-relative bound (the scheme's natural error measure).
    colscale = np.abs(a).max(0)[:, None] * np.abs(b).max(0)[None, :] * a.shape[0]
    assert np.max(np.abs(got - ref) / colscale) < 1e-14


def test_ozaki_chunked_rows():
    rng = np.random.default_rng(2)
    n = (1 << 17) + 333  # forces the multi-chunk path
    a = rng.random((n, 8))
    b = rng.random((n, 4))
    got = np.asarray(jax.jit(ozaki_contract)(jnp.asarray(a), jnp.asarray(b)))
    assert _relerr(got, a.T @ b) < 1e-13


def test_ozaki_zero_and_negative_columns():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((100, 5))
    a[:, 2] = 0.0
    b = -rng.random((100, 3))
    got = np.asarray(ozaki_contract(jnp.asarray(a), jnp.asarray(b)))
    ref = a.T @ b
    np.testing.assert_allclose(got, ref, atol=1e-12)
    assert np.all(got[2] == 0.0)


def test_outer_accumulate_small_n():
    rng = np.random.default_rng(4)
    for n in (1, 2, 7):
        a = rng.standard_normal((n, 6))
        b = rng.standard_normal((n, 3))
        got = np.asarray(outer_accumulate_contract(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, a.T @ b, rtol=1e-14, atol=1e-14)


def test_contract_mode_dispatch():
    rng = np.random.default_rng(5)
    a = rng.random((50, 4))
    b = rng.random((50, 3))
    for mode in ("auto", "native", "exact"):
        got = np.asarray(contract(jnp.asarray(a), jnp.asarray(b), mode=mode))
        np.testing.assert_allclose(got, a.T @ b, rtol=1e-12)


def test_contract_vmaps():
    rng = np.random.default_rng(6)
    a = rng.random((10, 20, 4))
    b = rng.random((10, 20, 3))
    f = jax.vmap(lambda x, y: contract(x, y, mode="exact"))
    got = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
    ref = np.einsum("fnk,fnm->fkm", a, b)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_contract_f32_native():
    rng = np.random.default_rng(7)
    a = rng.random((100, 8)).astype(np.float32)
    b = rng.random((100, 5)).astype(np.float32)
    got = contract(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(got), a.T.astype(np.float64) @ b.astype(np.float64), rtol=1e-5
    )


def test_ozaki_group_paths_both_branches():
    """Both group recombinations (prefix-stack and scanned) are correct.

    Outputs above 2048^2 elements take the scanned one-int32-buffer form
    (the unrolled prefix matmuls keep several multi-GB int32 products alive
    at genomics-wide K); small outputs keep the
    faster prefix-stack form. Same math either way.
    """
    rng = np.random.default_rng(5)
    for k, c in ((40, 24), (2080, 2080)):  # below / above the threshold
        a = jnp.asarray(rng.normal(size=(48, k)))
        b = jnp.asarray(rng.normal(size=(48, c)))
        got = np.asarray(ozaki_contract(a, b))
        ref = np.asarray(a).T @ np.asarray(b)
        assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 1e-12


def test_symmetric_contract_matches_full():
    """SYRK block skipping: f64-grade, exactly-mirrored strict blocks."""
    from cvmatrix_tpu.ops.precise import symmetric_contract

    rng = np.random.default_rng(7)
    n, k, m = 1200, 300, 4
    x = rng.random((n, k)) * 10 - 5
    w = rng.random(n)
    a = jnp.asarray(x * w[:, None])
    b = jnp.asarray(np.concatenate([x, rng.random((n, m))], axis=1))
    ref = np.asarray(a).T @ np.asarray(b)
    got = np.asarray(symmetric_contract(a, b, k, col_block=128))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 1e-14
    # mirrored strict blocks are exact transposes; only the diagonal
    # blocks carry the weighted operand's rounding asymmetry
    xb = got[:, :k]
    off = xb[:128, 128:256] - xb[128:256, :128].T
    assert np.max(np.abs(off)) == 0.0


def test_symmetric_contract_no_y_and_row_chunking():
    from cvmatrix_tpu.ops.precise import _GROUP_CHUNK, symmetric_contract

    rng = np.random.default_rng(8)
    n = _GROUP_CHUNK + 513  # cross a row-chunk boundary
    k = 160
    x = rng.random((n, k)) - 0.5
    a = jnp.asarray(x * rng.random(n)[:, None])
    b = jnp.asarray(x)
    ref = np.asarray(a).T @ np.asarray(b)
    got = np.asarray(symmetric_contract(a, b, k, col_block=128))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-14


def test_symmetric_contract_weighted_column_exponents():
    """Mirrored entries must carry position-correct column scales.

    Regression: the assembly used to transpose RAW accumulator blocks and
    scale by output position afterwards, which is wrong by
    2^((e_a-e_b)[p] - (e_a-e_b)[q]) whenever the weighted operand's
    per-column exponent pattern differs from the unweighted twin's —
    adversarial weights here make mirrored entries off by 512x before
    the fix.
    """
    from cvmatrix_tpu.ops.precise import symmetric_contract

    rng = np.random.default_rng(7)
    n, k, m = 400, 256, 3
    x = rng.random((n, k))
    # Column 0's largest |x| sits on rows whose weight is tiny, driving
    # e_a[0] far below e_b[0] while other columns keep e_a == e_b.
    x[:10, 0] = 1000.0
    w = rng.random(n) + 0.5
    w[:10] = 2.0 ** -9
    a = x * w[:, None]                       # weighted operand (WX)
    b = np.concatenate([x, rng.random((n, m))], axis=1)
    got = np.asarray(symmetric_contract(
        jnp.asarray(a), jnp.asarray(b), k, col_block=128))
    ref = a.T @ b
    np.testing.assert_allclose(got, ref, rtol=1e-13,
                               atol=1e-9 * np.abs(ref).max())


def test_ozaki_contract_extreme_magnitudes():
    """Columns far outside the f32 exponent range (round-3 review finding:
    the old f32 clamp saturated the column exponent and int8 slices
    overflowed — silently wrong where NumPy f64 is exact)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 6))
    b = rng.standard_normal((64, 4))
    a[:, 0] *= 1e200   # e ~ +665
    a[:, 1] *= 1e-250  # deep small
    b[:, 2] *= 1e150
    ref = a.T @ b
    got = np.asarray(ozaki_contract(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=5e-14)


def test_pow2_full_f64_exponent_range():
    # +1074 overflows to inf (correct); the deep-subnormal tail below
    # -1060 may flush to zero under XLA and is excluded (the rescale it
    # feeds is already underflowed-to-negligible there).
    e = np.array([0, 254, 256, -256, 1000, -1000, 1060, 1074], np.int32)
    got = np.asarray(_pow2(jnp.asarray(e)))
    expect = np.ldexp(1.0, e)
    np.testing.assert_array_equal(got, expect)


def test_symmetric_contract_k_just_above_block():
    """k just above the column block must not pessimize or lose accuracy:
    blocks are equalized (round-3 review finding)."""
    rng = np.random.default_rng(6)
    n, k, m = 300, 2049, 3
    a = rng.standard_normal((n, k))
    # b[:, :k] must be the unweighted twin of a for the SYRK contract:
    w = rng.random(n)
    aw = a * w[:, None]
    bb = np.concatenate([a, rng.standard_normal((n, m))], axis=1)
    ref = aw.T @ bb
    got = np.asarray(symmetric_contract(jnp.asarray(aw), jnp.asarray(bb), k))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 1e-14


def test_symmetric_contract_unweighted_shared_slices():
    """``unweighted_x=True`` (slices computed once, shared by both
    operands) must equal the two-operand path bit-for-bit AND the NumPy
    f64 reference — incl. across a row-chunk boundary and with Y."""
    from cvmatrix_tpu.ops.precise import _GROUP_CHUNK, symmetric_contract

    rng = np.random.default_rng(11)
    n, k, m = _GROUP_CHUNK + 257, 192, 3
    x = rng.random((n, k)) * 200 - 100
    b = np.concatenate([x, rng.standard_normal((n, m))], axis=1)
    a_j, b_j = jnp.asarray(x), jnp.asarray(b)
    ref = x.T @ b
    got_shared = np.asarray(
        symmetric_contract(a_j, b_j, k, col_block=128, unweighted_x=True))
    got_two = np.asarray(symmetric_contract(a_j, b_j, k, col_block=128))
    np.testing.assert_array_equal(got_shared, got_two)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got_shared - ref)) / scale < 1e-14
    # Unweighted X block: strictly symmetric, mirrored exactly.
    xb = got_shared[:, :k]
    np.testing.assert_array_equal(xb, xb.T)


def test_contract_rejects_unknown_mode():
    a = jnp.ones((4, 3))
    with pytest.raises(ValueError, match="matmul mode"):
        contract(a, a, mode="exakt")
