"""Batched folds in one compiled program — the fast path.

Counterpart of the reference's ``examples/training_matrices_jax.py``
(``jax.jit(jax.vmap(...))`` over equal-size folds), extended with the
padded+masked batch that handles UNEQUAL folds in a single program.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from cvmatrix_tpu import CVMatrix, Partitioner

if __name__ == "__main__":
    rng = np.random.default_rng(42)
    N, K, M = 100, 10, 3
    X = rng.uniform(size=(N, K))
    Y = rng.uniform(size=(N, M))
    weights = rng.uniform(size=(N,)) + 0.1

    # --- equal-size folds: plain stacked batch --------------------------
    folds = np.arange(N) % 5
    cvm = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True)
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    assert mask is None  # equal folds -> no mask needed

    batched = jax.jit(jax.vmap(cvm.training_XTX_XTY))
    (XTWX, XTWY), (X_mean, X_std, Y_mean, Y_std) = batched(jnp.asarray(idx_batch))
    print(f"folds: {keys}")
    print(f"batched XTWX: {XTWX.shape}  (n_folds, K, K)")
    print(f"batched XTWY: {XTWY.shape}  (n_folds, K, M)")

    # Cross-check fold 0 against the eager path.
    (XTWX0, XTWY0), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    print("max |batched - eager|:", float(jnp.max(jnp.abs(XTWX[0] - XTWX0))))

    # --- unequal folds: padded + masked, still ONE program --------------
    folds = np.concatenate([np.zeros(17), np.ones(33), np.full(50, 2.0)])
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    (XTWX, XTWY), _ = batched(jnp.asarray(idx_batch), jnp.asarray(mask))
    (ref, _), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    print("masked batch vs eager:", float(jnp.max(jnp.abs(XTWX[0] - ref))))
