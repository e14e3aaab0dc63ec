"""Scaling over a device mesh: row-sharded fit + fold-sharded fold math.

Run on a multi-GPU host, or simulate on CPU with:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/training_matrices_mesh.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from cvmatrix_tpu import CVConfig, Partitioner
from cvmatrix_tpu.parallel.distributed import (
    fit_sharded,
    make_mesh,
    sharded_training_matrices,
)

if __name__ == "__main__":
    if np.dtype(np.float64).itemsize >= 8:
        jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(42)
    N, K, M = 10_000, 64, 4
    X = rng.uniform(size=(N, K))
    Y = rng.uniform(size=(N, M))
    weights = rng.uniform(size=N) + 0.1
    folds = np.arange(N) % 100

    mesh = make_mesh()
    print(f"mesh: {mesh.shape} over {len(jax.devices())} {jax.devices()[0].platform} devices")

    cfg = CVConfig(center_X=True, center_Y=True, scale_X=True, scale_Y=True)
    state = fit_sharded(cfg, mesh, X, Y, weights)
    print("fit: XTX", state.XTX.shape, "sharding:", state.XTX.sharding.spec)
    print("fit: X  ", state.X.shape, "sharding:", state.X.sharding.spec)

    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    (XTWX, XTWY), stats = sharded_training_matrices(
        cfg, state, idx_batch, mask, mesh=mesh
    )
    jax.block_until_ready(XTWX)
    print("fold outputs:", XTWX.shape, "sharding:", XTWX.sharding.spec)
