"""Headline benchmark: weighted all-on LOOCV on the reference grid.

Reproduces the reference's flagship configuration
(``benchmarks/benchmark.py:222-252``): N=100,000 samples, K=500 features,
M=10 targets, float64, random nonuniform weights, all four center/scale
flags on, P=100,000-fold (leave-one-out) cross-validation. The measured
quantity is the reference's: total cross-validation time = one fit + the
training matrices of ALL folds (warm-JIT, matching the reference's
``warmjit`` mode, ``benchmarks/benchmark.py:207-213``).

Baseline: the fastest published reference number for this configuration is
1.299 s total on an RTX 3090 Ti (JAX backend, warm JIT —
``benchmarks/benchmark_results_jax.csv:106``; see BASELINE.md), i.e. ~76,982
folds/s. ``vs_baseline`` is our folds/s over that.

Prints ONE JSON line to stdout; diagnostics (including the card's name and
power limit) go to stderr. Environment knobs (reference-compatible):
BENCH_N, BENCH_K, BENCH_M, BENCH_P, BENCH_BATCH (0 = auto), BENCH_DTYPE.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    # BENCH_PLATFORM=cpu pins the backend (smoke tests / host comparisons).
    if os.environ.get("BENCH_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["BENCH_PLATFORM"])

    N = int(os.environ.get("BENCH_N", 100_000))
    K = int(os.environ.get("BENCH_K", 500))
    M = int(os.environ.get("BENCH_M", 10))
    P = int(os.environ.get("BENCH_P", N))  # LOOCV by default
    dtype = np.dtype(os.environ.get("BENCH_DTYPE", "float64")).type
    batch = int(os.environ.get("BENCH_BATCH", 0)) or None  # None: budget auto

    if np.dtype(dtype).itemsize >= 8:
        jax.config.update("jax_enable_x64", True)

    from cvmatrix_tpu import CVConfig, Partitioner, fit
    from cvmatrix_tpu.models.sweep import materialize_cv, materialize_sweep
    from cvmatrix_tpu.utils import enable_persistent_cache
    from cvmatrix_tpu.utils.profiling import card_description

    if os.environ.get("BENCH_PERSISTENT_CACHE", "1") != "0":
        log(f"persistent compile cache: {enable_persistent_cache()}")

    dev = jax.devices()[0]
    log(f"bench: N={N} K={K} M={M} P={P} dtype={np.dtype(dtype).name} "
        f"batch={batch} device={dev.platform}/{dev.device_kind}")

    rng = np.random.default_rng(42)
    X = rng.random((N, K), dtype=np.float64).astype(dtype)
    Y = rng.random((N, M), dtype=np.float64).astype(dtype)
    weights = rng.random(N).astype(dtype)
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=dtype)

    # Fold index batches, bucketed by size so every bucket vmaps with one
    # fixed shape (the reference driver's strategy, benchmark.py:144-152).
    p = Partitioner(np.arange(N) % P)
    buckets = {}
    for k, v in p.folds_dict.items():
        buckets.setdefault(v.size, []).append(v)
    stacks = [jnp.asarray(np.stack(vs)) for vs in buckets.values()]

    jfit = jax.jit(
        lambda c, x, y, w: fit(c, x, y, w, validate=False), static_argnums=(0,)
    )
    Xd, Yd, wd = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(weights)

    # Every timing ends in jax.block_until_ready on a value that depends on
    # all the device work being timed: JAX dispatch is asynchronous, so the
    # host clock would otherwise stop at enqueue.
    def fit_once():
        return jax.block_until_ready(jfit(cfg, Xd, Yd, wd))

    # Fold sweep: one compiled fori_loop per size bucket materialises every
    # fold's training matrices in device memory (materialize_sweep). Bucket
    # probes accumulate on device; one wait at the end covers them all.
    def run_folds(st):
        s = None
        for stack in stacks:
            pr = materialize_sweep(cfg, st, stack, batch_size=batch)
            s = pr if s is None else s + pr
        return jax.block_until_ready(s)

    # Measured: total CV = fit + all folds, chained on device with a single
    # completion wait at the end — the reference's methodology (fit + every
    # fold, then one block_until_ready: ``benchmarks/benchmark.py:148-152``).
    # With a single fold-size bucket (the common case) materialize_cv runs
    # fit + sweep as one compiled program.
    if len(stacks) == 1:
        def total_cv():
            return jax.block_until_ready(materialize_cv(
                cfg, Xd, Yd, wd, stacks[0], batch_size=batch, validate=False,
            ))
    else:
        def total_cv():
            return run_folds(jfit(cfg, Xd, Yd, wd))

    if os.environ.get("BENCH_PHASES", "1") != "0":
        # Per-phase breakdown (informational): compile pass, then warm runs.
        t0 = time.perf_counter()
        state = fit_once()
        log(f"fit compile+run: {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        run_folds(state)
        log(f"folds compile+first run: {time.perf_counter() - t0:.3f}s")
        state = None  # release before refit
        t0 = time.perf_counter()
        state = fit_once()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_folds(state)
        t_folds = time.perf_counter() - t0
        state = None
        log(f"warm phases: fit={t_fit:.4f}s folds={t_folds:.4f}s")

    t0 = time.perf_counter()
    total_cv()
    log(f"total-CV compile+first run: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    total_cv()
    total = time.perf_counter() - t0
    folds_per_sec = P / total
    log(f"warm total CV: {total:.4f}s -> {folds_per_sec:,.0f} folds/s")
    stats = dev.memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"peak device memory: {stats['peak_bytes_in_use'] / 1e9:.2f} GB")
    log(f"card: {card_description()}")

    baseline_folds_per_sec = 100_000 / 1.299  # ref RTX 3090 Ti warm JIT
    name = (
        f"weighted_TTTT_P{P}_total_cv_folds_per_sec_"
        f"n{N}_k{K}_{np.dtype(dtype).name}"
    )
    print(json.dumps({
        "metric": name,
        "value": round(folds_per_sec, 1),
        "unit": "folds/s",
        "vs_baseline": round(folds_per_sec / baseline_folds_per_sec, 3),
    }))


if __name__ == "__main__":
    main()
