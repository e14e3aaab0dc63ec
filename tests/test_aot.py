"""AOT export/load roundtrip (the cross-machine cold-start story)."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from cvmatrix_tpu import CVConfig, fit
from cvmatrix_tpu.core.batch import training_matrices_batched
from cvmatrix_tpu.utils import export_program, load_program
from cvmatrix_tpu.utils.aot import _MAGIC

from .data import make_dataset

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=120, k=5, m=2)


def test_aot_roundtrip_fold_sweep(tmp_path):
    """Export a real fold-sweep program, reload from disk, same numbers."""
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    idx = jnp.asarray(np.arange(40).reshape(4, 10))

    def sweep(state, idx):
        return training_matrices_batched(cfg, state, idx, None)

    path = str(tmp_path / "sweep.aot")
    size = export_program(sweep, (st, idx), path, platforms=["cpu"])
    assert size > 1000
    # same whole-program jit on both sides -> identical fusion decisions
    direct = jax.jit(sweep)(st, idx)
    loaded = load_program(path)(st, idx)
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(loaded)):
        assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=0)


def test_aot_cuda_platform_artifact_builds_on_cpu_host(tmp_path):
    """A cuda-platform artifact lowers on a CPU-only build host (no GPU
    needed to export); running it on a cpu runtime then fails cleanly."""
    cfg = CVConfig(True, True, False, False, ddof=1, dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    idx = jnp.asarray(np.arange(8).reshape(2, 4))

    def sweep(state, idx):
        return training_matrices_batched(cfg, state, idx, None)

    path = str(tmp_path / "sweep_cuda.aot")
    export_program(sweep, (st, idx), path, platforms=["cuda"])
    with pytest.raises(Exception, match="(?i)platform"):
        load_program(path)(st, idx)


def test_aot_default_platform_is_running_backend(tmp_path):
    """Without ``platforms`` the artifact targets the backend it was traced
    on, so it loads and runs there with the same numbers."""
    cfg = CVConfig(True, True, False, False, ddof=1, dtype=np.float64)
    st = fit(cfg, X_ALL, Y_ALL, WEIGHTS)
    idx = jnp.asarray(np.arange(8).reshape(2, 4))

    def sweep(state, idx):
        return training_matrices_batched(cfg, state, idx, None)

    path = str(tmp_path / "x.aot")
    export_program(sweep, (st, idx), path)
    with open(path, "rb") as f:
        exp = jax.export.deserialize(bytearray(f.read()[len(_MAGIC):]))
    assert exp.platforms == (jax.default_backend(),)
    direct = jax.jit(sweep)(st, idx)
    loaded = load_program(path)(st, idx)
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(loaded)):
        assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=0)


def test_aot_rejects_foreign_file(tmp_path):
    path = str(tmp_path / "junk.aot")
    with open(path, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="artifact"):
        load_program(path)
