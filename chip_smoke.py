"""Smoke run of the engine's main path on the GPU, checked against the oracle.

Run from the repository root:

    python chip_smoke.py               # one GPU: phases a-d
    python chip_smoke.py --four-cards  # four GPUs of one host: the mesh phase

Phases (one process; every phase prints its compile time, warm time, peak
device memory and largest error beside its tolerance):

a. Headline, the reference's flagship deployment: weighted, all four
   center/scale flags, float64, N=100,000, K=500, M=10, leave-one-out. The
   timed call is ``materialize_cv`` (fit + every fold); the check is a
   ``cross_validate_reduce`` digest of all 100,000 folds against the NumPy
   oracle (``tests/oracle.py``) on 8 folds, plus the full matrices of 2 folds
   from the eager ``CVMatrix``.
b. Mid-band: the same data in 1,000 folds of 100 rows.
c. NIR-shaped deployment: N=10,000, K=500, M=1, 10 folds, all 16
   center/scale combinations in float64 through ``CVMatrix`` and
   ``jax.jit(jax.vmap(...))``, plus one float32 run.
d. ``matmul_mode="exact"``: the int8-slice contraction at N=100,000,
   K=500+10 against the card's native float64 product.
e. ``--four-cards`` only: row-sharded fit at N=1,000,000 over a 4-device
   mesh, a padded uneven-fold batch and a 100-fold mesh reduce, against the
   one-card engine.

Exits nonzero, printing no result, when JAX finds no GPU or any phase fails.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TOL_F64 = 1e-8  # the repo's contract, times max(1, |ref|max)
TOL_F32 = 1e-3
TOL_EXACT = 1e-12  # exact mode vs the native product, times max|ref|
STORE_FLOOR_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def last_line(platform: str, kind: str, count: int) -> str:
    """The result line: ``{"ok": true, "device": {...}}``."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def select_phases(four_cards: bool) -> list:
    """The phases a run executes, in order."""
    if four_cards:
        return [phase_mesh]
    return [phase_headline, phase_midband, phase_nir, phase_exact]


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {found!r}")


class PhaseFailure(RuntimeError):
    pass


def check(name: str, err: float, tol: float) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {name}: max error {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailure(f"{name}: error {err:.3e} above {tol:.3e}")


def scaled_err(got, want) -> tuple:
    """(max |got - want|, max(1, |want|max)) in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise PhaseFailure(f"shape {got.shape} != {want.shape}")
    return (float(np.max(np.abs(got - want))),
            max(1.0, float(np.max(np.abs(want)))))


def timed(fn):
    """(first-call seconds, warm seconds, result): both calls block."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return first, time.perf_counter() - t0, out


def report_times(label: str, first: float, warm: float) -> None:
    print(f"  {label}: compile {max(first - warm, 0.0):.3f} s "
          f"(first call {first:.3f} s), warm {warm:.4f} s", flush=True)


def report_memory(devices) -> None:
    for d in devices:
        st = d.memory_stats() or {}
        print(f"  {d}: peak_bytes_in_use "
              f"{st.get('peak_bytes_in_use', 0) / 1e9:.3f} GB, "
              f"bytes_in_use {st.get('bytes_in_use', 0) / 1e9:.3f} GB",
              flush=True)


def make_data(n: int, k: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.random((n, k)), rng.random((n, m)), rng.random(n)


def oracle_mats(oracle, n: int, val_rows):
    train = np.setdiff1d(np.arange(n), np.asarray(val_rows).reshape(-1))
    (ox, oy), _ = oracle.training_XTX_XTY(train)
    return ox, oy


def digest(mats, stats):
    import jax.numpy as jnp

    xtx, xty = mats
    k = xtx.shape[0]
    # Explicit indices: a reshape(-1)[0] of a sliced matrix forces a copy.
    return jnp.stack([xtx[0, 0], xtx[k - 1, k - 1], xty[0, 0],
                      jnp.trace(xtx)])


def oracle_digest(ox, oy):
    return np.array([ox[0, 0], ox[-1, -1], oy[0, 0], np.trace(ox)])


def check_digests(name, got, idx, oracle, n, folds):
    errs = []
    for f in folds:
        ox, oy = oracle_mats(oracle, n, idx[f])
        err, scale = scaled_err(got[f], oracle_digest(ox, oy))
        errs.append(err / scale)
    check(f"{name} digest vs oracle on folds {list(folds)} "
          "(relative to max(1, |ref|))", max(errs), TOL_F64)


def check_folds(name, cvm, idx, oracle, n, folds):
    for f in folds:
        (fx, fy), _ = cvm.training_XTX_XTY(np.asarray(idx[f]))
        ox, oy = oracle_mats(oracle, n, idx[f])
        err_x, sx = scaled_err(fx, ox)
        err_y, sy = scaled_err(fy, oy)
        check(f"{name} fold {f} full XTX/XTY vs oracle (relative)",
              max(err_x / sx, err_y / sy), TOL_F64)


def sweep_phase(name, X, Y, w, idx, n_checked, seed, full_folds=()):
    """materialize_cv timing + cross_validate_reduce digest check."""
    import jax
    import jax.numpy as jnp

    from cvmatrix_tpu import CVConfig, CVMatrix, fit
    from cvmatrix_tpu.models.sweep import (
        _chunking,
        cross_validate_reduce,
        materialize_cv,
    )
    from tests.oracle import NaiveOracle

    n, k = X.shape
    m = Y.shape[1]
    p_folds = idx.shape[0]
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    Xd, Yd, wd, idx_d = (jnp.asarray(a) for a in (X, Y, w, idx))

    first, warm, probe = timed(
        lambda: materialize_cv(cfg, Xd, Yd, wd, idx_d, validate=False))
    report_times("materialize_cv (fit + all folds)", first, warm)
    out_bytes = p_folds * k * (k + m) * 8
    print(f"  {p_folds} folds in {warm:.4f} s = {p_folds / warm:,.0f} "
          f"folds/s; fold outputs {out_bytes / 1e9:.1f} GB -> "
          f"{out_bytes / warm / 1e12:.3f} TB/s = "
          f"{out_bytes / warm / STORE_FLOOR_BYTES_PER_S:.1%} of the "
          f"{STORE_FLOOR_BYTES_PER_S / 1e12:.2f} TB/s store floor",
          flush=True)

    oracle = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, w)
    # The probe is the first element of the last chunk's first fold.
    bs = _chunking(p_folds, k, k + m, 8, None, 4e9)
    pf = (-(-p_folds // bs) - 1) * bs
    ox, oy = oracle_mats(oracle, n, idx[pf])
    err, scale = scaled_err(probe, ox[0, 0] + oy[0, 0])
    check(f"{name} materialize_cv probe (fold {pf}) vs oracle (relative)",
          err / scale, TOL_F64)

    st = jax.block_until_ready(fit(cfg, Xd, Yd, wd))
    first, warm, got = timed(lambda: cross_validate_reduce(
        cfg, st, idx_d, reduce_fn=digest))
    report_times(f"cross_validate_reduce over {p_folds} folds", first, warm)
    got = np.asarray(got)
    if got.shape != (p_folds, 4) or not np.all(np.isfinite(got)):
        raise PhaseFailure(f"{name}: digest shape {got.shape} or non-finite")
    rng = np.random.default_rng(seed)
    inner = rng.choice(np.arange(1, p_folds - 1), n_checked - 2,
                       replace=False)
    folds = [0, *sorted(int(f) for f in inner), p_folds - 1]
    check_digests(name, got, idx, oracle, n, folds)
    if full_folds:
        cvm = CVMatrix(True, True, True, True, 1).fit(Xd, Yd, wd)
        check_folds(name, cvm, idx, oracle, n,
                    [folds[i] for i in full_folds])


def phase_headline(devices, n=100_000, k=500, m=10, seed=0):
    """a. Weighted TTTT float64 LOOCV (BASELINE config 3)."""
    print(f"phase a: headline LOOCV, weighted TTTT f64, N={n} K={k} M={m}",
          flush=True)
    X, Y, w = make_data(n, k, m, seed)
    sweep_phase("headline", X, Y, w, np.arange(n)[:, None], 8, seed + 1,
                full_folds=(0, 4))


def phase_midband(devices, n=100_000, k=500, m=10, p=1000, seed=0):
    """b. The same data in P folds of N/P rows."""
    print(f"phase b: mid-band, P={p} folds of {n // p} rows", flush=True)
    X, Y, w = make_data(n, k, m, seed)
    idx = np.stack([np.arange(f, n, p) for f in range(p)])
    sweep_phase("mid-band", X, Y, w, idx, 4, seed + 2)


def phase_nir(devices, n=10_000, k=500, n_folds=10, seed=0):
    """c. NIR-shaped data, all 16 combinations (BASELINE config 2)."""
    from itertools import product

    import jax

    from cvmatrix_tpu import CVMatrix, Partitioner
    from tests.data import make_nir_like_dataset
    from tests.oracle import NaiveOracle

    print(f"phase c: NIR-shaped N={n} K={k} M=1, {n_folds} folds, "
          "16 combinations", flush=True)
    X, Y, _, w = make_nir_like_dataset(n=n, k=k, m=2, seed=seed)
    Y = Y[:, :1]
    p = Partitioner(np.arange(n) % n_folds)
    keys = list(p.folds_dict)
    val = np.stack([p.get_validation_indices(f) for f in keys])
    first_total = warm_total = 0.0
    worst = 0.0
    for flags in product([False, True], repeat=4):
        cvm = CVMatrix(*flags, ddof=1, dtype=np.float64).fit(X, Y, w)
        run = jax.jit(jax.vmap(cvm.training_XTX_XTY))
        first, warm, ((bx, by), _) = timed(lambda: run(val))
        first_total += first
        warm_total += warm
        oracle = NaiveOracle(*flags, ddof=1).fit(X, Y, w)
        for f in (0, n_folds - 1):
            ox, oy = oracle_mats(oracle, n, val[f])
            ex, sx = scaled_err(bx[f], ox)
            ey, sy = scaled_err(by[f], oy)
            worst = max(worst, ex / sx, ey / sy)
    report_times("16 x jit(vmap(training_XTX_XTY)), summed",
                 first_total, warm_total)
    check("16 combinations f64 vs oracle, folds 0 and last (relative)",
          worst, TOL_F64)

    Xf, Yf, wf = (a.astype(np.float32) for a in (X, Y, w))
    cvm = CVMatrix(True, True, True, True, ddof=1, dtype=np.float32).fit(
        Xf, Yf, wf)
    run = jax.jit(jax.vmap(cvm.training_XTX_XTY))
    first, warm, ((bx, by), _) = timed(lambda: run(val))
    report_times("float32 TTTT jit(vmap)", first, warm)
    oracle = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, w)
    worst = 0.0
    for f in (0, n_folds - 1):
        ox, oy = oracle_mats(oracle, n, val[f])
        ex, sx = scaled_err(bx[f], ox)
        ey, sy = scaled_err(by[f], oy)
        worst = max(worst, ex / sx, ey / sy)
    check("float32 TTTT vs float64 oracle (relative)", worst, TOL_F32)


def phase_exact(devices, n=100_000, k=500, m=10, seed=0):
    """d. ``contract(mode="exact")`` against the native float64 product."""
    import jax
    import jax.numpy as jnp

    from cvmatrix_tpu.ops.precise import contract

    print(f"phase d: exact-mode contraction, N={n} K={k}+{m}", flush=True)
    X, Y, w = make_data(n, k, m, seed)
    WX = jnp.asarray(X * w[:, None])
    XY = jnp.asarray(np.concatenate([X, Y], axis=1))
    native = jax.jit(lambda a, b: contract(a, b, mode="native"))
    exact = jax.jit(lambda a, b: contract(a, b, mode="exact",
                                          symmetric_k=k))
    first, warm, ref = timed(lambda: native(WX, XY))
    report_times("native float64 contraction", first, warm)
    first, warm, got = timed(lambda: exact(WX, XY))
    report_times("exact int8-slice contraction", first, warm)
    ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    check("exact vs native (relative to max|ref|)",
          err / float(np.max(np.abs(ref))), TOL_EXACT)


def phase_mesh(devices, n=1_000_000, k=500, m=10, n_reduce_folds=100,
               seed=0):
    """e. The row-sharded mesh path on four devices vs one device."""
    import jax
    import jax.numpy as jnp

    from cvmatrix_tpu import CVConfig, Partitioner, fit
    from cvmatrix_tpu.models.sweep import cross_validate_reduce
    from cvmatrix_tpu.parallel.distributed import (
        fit_sharded,
        make_mesh,
        sharded_cross_validate_reduce,
        sharded_training_matrices,
    )
    from tests.oracle import NaiveOracle

    if len(devices) < 4:
        raise PhaseFailure(f"mesh phase needs 4 devices, found {len(devices)}")
    mesh = make_mesh(devices[:4])
    print(f"phase e: mesh over {mesh.devices.size} devices, weighted TTTT "
          f"f64, N={n} K={k} M={m}", flush=True)
    X, Y, w = make_data(n, k, m, seed)
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)

    first, warm, st = timed(lambda: fit_sharded(cfg, mesh, X, Y, w))
    report_times("fit_sharded (incl. host-to-device copy)", first, warm)
    print("  per-device memory after the sharded fit:", flush=True)
    report_memory(devices[:4])
    shards = {s.device: s.data.shape for s in st.X.addressable_shards}
    print(f"  X shards: {shards}", flush=True)
    if len(shards) != 4 or any(sh[0] != n // 4 for sh in shards.values()):
        raise PhaseFailure(f"X is not row-sharded over 4 devices: {shards}")

    one = devices[0]
    Xd, Yd, wd = (jax.device_put(a, one) for a in (X, Y, w))
    st1 = jax.block_until_ready(fit(cfg, Xd, Yd, wd))
    err, scale = scaled_err(st.XTX, st1.XTX)
    check("sharded fit XTX vs one device (relative)", err / scale, TOL_F64)

    # Uneven folds, padded + masked: sizes from 1 to 2,000 rows.
    rng = np.random.default_rng(seed + 3)
    sizes = [1, 7, 64, 333, 1000, 2000, 12, 250]
    rows = rng.permutation(n)[: sum(sizes)]
    labels = np.repeat(np.arange(len(sizes)), sizes)
    p = Partitioner(labels)
    keys, local_idx, mask = p.padded_batches()
    idx = rows[np.asarray(local_idx)]
    first, warm, ((mx, my), _) = timed(lambda: sharded_training_matrices(
        cfg, st, idx, mask, mesh=mesh))
    report_times(f"sharded_training_matrices, {len(sizes)} uneven folds",
                 first, warm)
    oracle = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, w)
    worst = 0.0
    for f in (0, len(sizes) - 1, int(np.argmax(sizes))):
        val = rows[np.asarray(p.get_validation_indices(keys[f]))]
        ox, oy = oracle_mats(oracle, n, val)
        ex, sx = scaled_err(mx[f], ox)
        ey, sy = scaled_err(my[f], oy)
        worst = max(worst, ex / sx, ey / sy)
    check("uneven-fold mesh matrices vs oracle (relative)", worst, TOL_F64)

    ridx = np.stack([np.arange(f, n, n_reduce_folds)
                     for f in range(n_reduce_folds)])
    first, warm, red = timed(lambda: sharded_cross_validate_reduce(
        cfg, st, ridx, mesh=mesh, reduce_fn=digest))
    report_times(f"sharded_cross_validate_reduce, {n_reduce_folds} folds",
                 first, warm)
    first, warm, red1 = timed(lambda: cross_validate_reduce(
        cfg, st1, jnp.asarray(ridx), reduce_fn=digest))
    report_times("one-device cross_validate_reduce, same folds", first, warm)
    err, scale = scaled_err(red, red1)
    check(f"mesh reduce vs one device over {n_reduce_folds} folds "
          "(relative)", err / scale, TOL_F64)
    print("  per-device memory at the end:", flush=True)
    report_memory(devices[:4])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, over four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    require_gpu(devices)

    from cvmatrix_tpu.utils import enable_persistent_cache
    from cvmatrix_tpu.utils.profiling import card_description

    print(f"card: {card_description()}", flush=True)
    print(f"device_kind: {devices[0].device_kind}, devices: {len(devices)}",
          flush=True)
    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    t_all = time.perf_counter()
    for phase in select_phases(args.four_cards):
        t0 = time.perf_counter()
        phase(devices)
        print(f"  phase wall time {time.perf_counter() - t0:.1f} s; peak "
              "memory so far (cumulative over the process):", flush=True)
        report_memory(devices[:4] if args.four_cards else devices[:1])
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(last_line(devices[0].platform, devices[0].device_kind,
                    len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
