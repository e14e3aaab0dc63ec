"""Fused total-CV: fit + every fold's matrices as ONE compiled program.

``materialize_cv`` is the throughput primitive behind the headline
benchmark (the reference measures fit + all folds' training matrices as
one quantity, ``/root/reference/benchmarks/benchmark.py:148-152``): it
compiles the fit and the whole fold sweep into a single XLA program, so
there is no intermediate host dispatch between the phases.

The returned value is a probe scalar; waiting on it is the completion
barrier for everything; use :func:`materialize_sweep` /
:func:`cross_validate_reduce` when you need the per-fold results
themselves.

Runs on CPU or GPU.
"""

import time

import numpy as np

from cvmatrix_tpu import CVConfig
from cvmatrix_tpu.models.sweep import materialize_cv

N, K, M, P = 20_000, 64, 4, 100

rng = np.random.default_rng(0)
X = rng.random((N, K))
Y = rng.random((N, M))
weights = rng.random(N)
cfg = CVConfig(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
               ddof=1, dtype=np.float64)

# Equal-size folds stack directly; use Partitioner.padded_batches() for
# unequal folds (pass its mask as mask_batch).
idx_batch = np.stack([np.where(np.arange(N) % P == f)[0] for f in range(P)])

probe = float(materialize_cv(cfg, X, Y, weights, idx_batch))  # compile
t0 = time.perf_counter()
probe = float(materialize_cv(cfg, X, Y, weights, idx_batch))
dt = time.perf_counter() - t0
print(f"total CV (fit + {P} folds) in one program: {dt:.4f}s "
      f"({P / dt:,.0f} folds/s), probe={probe:.6g}")
