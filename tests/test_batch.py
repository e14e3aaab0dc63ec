"""Batched training matrices: the vmapped engine vs the eager per-fold one."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from cvmatrix_tpu import CVConfig, CVMatrix, Partitioner, fit
from cvmatrix_tpu.core.batch import training_matrices_batched

from .data import make_dataset

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=200, k=6, m=2)


@pytest.mark.parametrize("return_XTX,return_XTY", [(True, False),
                                                   (False, True)])
def test_batch_one_sided_matches_eager(return_XTX, return_XTY):
    """XTX-only and XTY-only batches over padded+masked unequal folds."""
    cfg = CVConfig(True, False, True, False, ddof=0, dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    ref = CVMatrix(True, False, True, False, 0).fit(X_ALL, Y_ALL, WEIGHTS)
    p = Partitioner(FOLDS)
    keys, idx, mask = p.padded_batches()
    got, _ = training_matrices_batched(
        cfg, st, idx, mask, return_XTX=return_XTX, return_XTY=return_XTY)
    for i, k in enumerate(keys):
        vi = p.get_validation_indices(k)
        want, _ = (ref.training_XTX(vi) if return_XTX
                   else ref.training_XTY(vi))
        assert_allclose(np.asarray(got[i]), np.asarray(want), atol=1e-10,
                        rtol=0)


def test_batch_errors():
    cfg = CVConfig(dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    with pytest.raises(ValueError, match="At least one"):
        training_matrices_batched(cfg, st, np.arange(4)[:, None],
                                  return_XTX=False, return_XTY=False)
    st_no_y = fit(cfg, X_ALL, None, WEIGHTS)
    with pytest.raises(ValueError, match="not provided"):
        training_matrices_batched(cfg, st_no_y, np.arange(4)[:, None])
