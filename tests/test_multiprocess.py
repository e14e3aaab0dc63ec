"""True multi-process agreement test (SURVEY §4: multi-node testing).

Spawns two OS processes that form a real ``jax.distributed`` cluster over
localhost (CPU backend, 2 virtual devices per process = a 4-device global
mesh), run the multihost sharded fit from host-local row blocks, and check
the psum-assembled globals against a single-process fit. This exercises the
actual multi-controller code path (`make_array_from_process_local_data`,
cross-process collectives) that the virtual-mesh suite cannot.
"""

import os
import socket
import subprocess
import sys


_WORKER = r"""
import os, sys
import numpy as np

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(coordinator_address=coord, num_processes=nproc,
                           process_id=pid, local_device_ids=[0, 1])
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc

sys.path.insert(0, os.getcwd())  # launched with cwd = repo root
from cvmatrix_tpu import CVConfig
from cvmatrix_tpu.parallel import multihost

N, K, M = 37, 5, 2  # deliberately not divisible by 4 devices
rng = np.random.default_rng(0)
X = rng.random((N, K))
Y = rng.random((N, M))
w = rng.random(N)

mesh = multihost.global_mesh()
start, stop = multihost.host_row_slice(N, mesh)
cfg = CVConfig(True, True, True, True, ddof=1)
state = multihost.fit_sharded_multihost(
    cfg, mesh, X[start:stop], Y[start:stop], w[start:stop], n_rows_global=N
)

xtx = np.asarray(jax.device_get(state.XTX))
sum_w = float(jax.device_get(state.sum_w))

# cross-process fold computation: mask-and-psum gathers + fold-sharded math
from cvmatrix_tpu.parallel.distributed import sharded_training_matrices
idx = np.arange(8)[None, :]  # one fold = rows 0..7
(fxtx, fxty), _ = sharded_training_matrices(cfg, state, idx, None, mesh=mesh)
fxtx = np.asarray(jax.device_get(fxtx[0]))

# Single-program mesh reduce across REAL process boundaries: every chunk
# gathers its folds' rows with one reduce-scatter spanning both processes,
# then runs the fold math shard-locally. Checked against the oracle below.
import jax.numpy as jnp
from jax.experimental import multihost_utils
from cvmatrix_tpu.parallel.distributed import sharded_cross_validate_reduce

rngf = np.random.default_rng(7)
sidx = np.stack([rngf.permutation(N)[:3] for _ in range(6)])
rfn = lambda mats, stats: jnp.trace(mats[0]) + jnp.sum(mats[1])
red = sharded_cross_validate_reduce(
    cfg, state, sidx, mesh=mesh, reduce_fn=rfn, batch_size=4)
red = np.asarray(multihost_utils.process_allgather(red, tiled=True))

# --- NON-CONTIGUOUS process->device layout (VERDICT r1 item 9) ---------
# Interleave the processes' devices in mesh-flat order: [p0d0, p1d0,
# p0d1, p1d1]. host_row_slice must refuse (it would mis-assign rows);
# host_row_ranges + fit_sharded_multihost must still produce the right
# globals.
from jax.sharding import Mesh
devs = sorted(jax.devices(), key=lambda d: (d.id % 2, d.process_index))
imesh = Mesh(np.array(devs), ("rows",))
noncontig = [d.process_index for d in devs] not in ([0, 0, 1, 1], [1, 1, 0, 0])
if noncontig:
    try:
        multihost.host_row_slice(N, imesh)
        raise SystemExit("host_row_slice accepted a non-contiguous layout")
    except ValueError:
        pass
ranges = multihost.host_row_ranges(N, imesh)
hb_rows = np.concatenate([np.arange(s, t) for _, s, t in ranges])
istate = multihost.fit_sharded_multihost(
    cfg, imesh, X[hb_rows], Y[hb_rows], w[hb_rows], n_rows_global=N
)
ixtx = np.asarray(jax.device_get(istate.XTX))

# negative weights must raise on the multi-process branch too (all rows
# negative so BOTH processes raise before any collective — one process
# proceeding alone would deadlock the cluster rather than fail).
bad = -np.abs(w) - 1.0
try:
    multihost.fit_sharded_multihost(
        cfg, imesh, X[hb_rows], Y[hb_rows], bad[hb_rows], n_rows_global=N
    )
    raise SystemExit("negative weights accepted on multiprocess branch")
except ValueError:
    pass

# ASYMMETRIC bad weight: the negative lives only in process 0's rows.
# The pre-flight verdict is agreed collectively, so BOTH processes must
# raise — a one-sided raise would strand the other process in the fit's
# psum until the collective timeout (round-3 review finding).
bad_one = np.abs(w) + 1.0
bad_one[0] = -1.0  # row 0: owned by process 0 under the contiguous mesh
try:
    multihost.fit_sharded_multihost(
        cfg, mesh, X[start:stop], Y[start:stop], bad_one[start:stop],
        n_rows_global=N,
    )
    raise SystemExit("asymmetric negative weight accepted")
except ValueError:
    pass

if pid == 0:
    # single-process truth
    WX = X * w[:, None]
    ref = WX.T @ X
    err = float(np.max(np.abs(xtx - ref)))
    assert err < 1e-10, f"multiprocess fit mismatch: {err}"
    assert abs(sum_w - w.sum()) < 1e-10
    ierr = float(np.max(np.abs(ixtx - ref)))
    assert noncontig, "interleaved mesh was unexpectedly contiguous"
    assert ierr < 1e-10, f"non-contiguous-layout fit mismatch: {ierr}"

    # fold truth: recompute training XTX from scratch (all-on config)
    ti = np.arange(8, N)
    Xt, wt = X[ti], w[ti]
    mX = np.average(Xt, axis=0, weights=wt)
    nnz = np.count_nonzero(wt)
    div = (nnz - 1) * wt.sum() / nnz
    sX = np.sqrt(np.sum(wt[:, None] * (Xt - mX) ** 2, axis=0) / div)
    Xc = (Xt - mX) / sX
    fref = (Xc * wt[:, None]).T @ Xc
    ferr = float(np.max(np.abs(fxtx - fref)))
    assert ferr < 1e-9, f"multiprocess fold mismatch: {ferr}"

    from tests.oracle import NaiveOracle
    oracle = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, w)
    for f in range(sidx.shape[0]):
        (ox, oy), _ = oracle.training_XTX_XTY(np.setdiff1d(np.arange(N), sidx[f]))
        want = np.trace(ox) + np.sum(oy)
        rerr = abs(float(red[f]) - want)
        assert rerr < 1e-8 * max(1.0, abs(want)), f"multiprocess reduce: {rerr}"
    print("MULTIPROCESS_OK", err, ferr)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_fit(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    env = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("XLA_", "JAX_"))
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(pid)],
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    assert any("MULTIPROCESS_OK" in out for _, out in outs), outs[0][1][-2000:]
