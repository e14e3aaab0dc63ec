"""Device-resident cross-validation: matrices consumed on device.

The reference workflow hands each fold's (K, K)/(K, M) training matrices
back to the host (or to a caller-side loop). On an accelerator the idiomatic
shape is to CONSUME them where they are produced: one compiled program sweeps every
fold, and a user reduction (here: a ridge solve for per-fold regression
coefficients, the downstream step of PLS/ridge-style pipelines) maps each
fold's matrices to a small result. Only the coefficients come back.

No reference equivalent (the reference leaves fold batching to the caller —
``benchmarks/benchmark.py:136-152``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from cvmatrix_tpu import CVMatrix, Partitioner

if __name__ == "__main__":
    rng = np.random.default_rng(7)
    N, K, M = 600, 40, 2
    X = rng.uniform(size=(N, K))
    beta_true = rng.normal(size=(K, M))
    Y = X @ beta_true + 0.01 * rng.normal(size=(N, M))
    weights = rng.uniform(size=N) + 0.1
    folds = np.arange(N) % 7

    cvm = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True)
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)

    LAM = 1e-6

    def ridge_coefficients(mats, stats):
        """Per-fold reduction, traced under vmap inside ONE program.

        The matrices are accumulated in float64; the small K x K solve
        runs in f32 — the usual split for downstream PLS/ridge steps.
        """
        xtx, xty = mats
        lhs = (xtx + LAM * jnp.eye(xtx.shape[0], dtype=xtx.dtype))
        return jnp.linalg.solve(
            lhs.astype(jnp.float32), xty.astype(jnp.float32)
        )

    keys, coefs = cvm.cross_validate_reduce(p, reduce_fn=ridge_coefficients)
    print(f"per-fold coefficients: {coefs.shape}  (n_folds, K, M)")

    # Cross-check fold 0 against the eager per-fold path.
    (xtx0, xty0), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    ref = np.linalg.solve(np.asarray(xtx0) + LAM * np.eye(K), np.asarray(xty0))
    print("max |sweep - eager solve|:",
          float(np.max(np.abs(np.asarray(coefs[0]) - ref))))
