"""Code-keyed identity for user callbacks in program-cache keys."""

import numpy as np

from cvmatrix_tpu import CVConfig, fit

from .data import make_dataset

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=96, k=6, m=2)


def test_fn_cache_key_distinguishes_bound_methods():
    """Bound methods of different instances share __code__ but close over
    different state — they must NOT alias to one cached program."""
    from cvmatrix_tpu.utils.fnkey import HashableFn, fn_cache_key

    class R:
        def __init__(self, scale):
            self.scale = scale

        def red(self, mats, stats):
            return mats[0].trace() * self.scale

    a, b = R(1.0), R(2.0)
    assert fn_cache_key(a.red) != fn_cache_key(b.red)
    assert HashableFn(a.red) != HashableFn(b.red)
    # same instance: stable across fresh bound-method objects
    assert fn_cache_key(a.red) == fn_cache_key(a.red)
    assert HashableFn(a.red) == HashableFn(a.red)


_GLOBAL_SCALE = 1.0


def test_fn_cache_key_tracks_rebound_globals():
    """A fresh lambda reading a rebound module global must re-trace: the
    key includes referenced globals' values (identity keying would have
    retraced fresh function objects; code keying must not regress that)."""
    global _GLOBAL_SCALE
    from cvmatrix_tpu.utils.fnkey import fn_cache_key

    def make():
        return lambda m, s: m * _GLOBAL_SCALE

    _GLOBAL_SCALE = 1.0
    k1 = fn_cache_key(make())
    k1b = fn_cache_key(make())
    assert k1 == k1b
    _GLOBAL_SCALE = 2.0
    try:
        assert fn_cache_key(make()) != k1
    finally:
        _GLOBAL_SCALE = 1.0


def test_bound_method_reduce_fns_not_aliased_end_to_end():
    """cross_validate_reduce with bound-method reduce_fns from two
    instances returns different numbers (the round-3 review repro)."""
    from cvmatrix_tpu.models.sweep import cross_validate_reduce

    cfg = CVConfig(True, True, True, True, 1)
    st = fit(cfg, X_ALL[:, :5], Y_ALL, WEIGHTS)
    idx = np.arange(24).reshape(4, 6)

    class R:
        def __init__(self, scale):
            self.scale = scale

        def red(self, mats, stats):
            return mats[0].trace() * self.scale

    a = cross_validate_reduce(cfg, st, idx, reduce_fn=R(1.0).red,
                              batch_size=2)
    b = cross_validate_reduce(cfg, st, idx, reduce_fn=R(2.0).red,
                              batch_size=2)
    np.testing.assert_allclose(np.asarray(b), 2.0 * np.asarray(a))
