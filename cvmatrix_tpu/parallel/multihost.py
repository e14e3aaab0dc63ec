"""Multi-host entry points (jax.distributed + host-local data feeding).

The reference is single-process; this is the new scaling layer SURVEY.md §2
calls for ("row sharding across hosts with psum assembling the globals").
The compute path is :mod:`cvmatrix_tpu.parallel.distributed` unchanged — a
``Mesh`` over all global devices makes its psum collectives span hosts. This
module adds the process-level plumbing:

- :func:`initialize` — ``jax.distributed.initialize`` with env autodetection.
- :func:`host_row_slice` — which dataset rows this process should load.
- :func:`fit_sharded_multihost` — build the row-sharded global arrays from
  host-local shards (no host ever materialises the full dataset) and run the
  sharded fit.

Single-host meshes degenerate gracefully (process_count() == 1), so the same
code runs everywhere. The multi-process path builds the global arrays with
per-device ``jax.make_array_from_single_device_arrays`` from the row ranges
:func:`host_row_ranges` assigns — each process loads exactly the rows of the
mesh positions whose devices it hosts, contiguous in mesh-flat order or not
(:func:`host_row_slice` refuses layouts it cannot express as one slice).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import CVConfig
from ..core.state import FitState
from .distributed import ROWS, fit_sharded, make_mesh

__all__ = [
    "initialize",
    "global_mesh",
    "host_row_ranges",
    "host_row_slice",
    "fit_sharded_multihost",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise the multi-process JAX runtime (no-op if single-process).

    Pass the arguments explicitly unless the cluster environment lets
    ``jax.distributed`` autodetect them.

    The already-initialised probe must NOT touch the device backends:
    ``jax.process_count()`` initialises them, after which
    ``jax.distributed.initialize`` always raises and a silent fallback
    would degrade every host to single-process mode (wrong global
    products with no error). Hence ``jax.distributed.is_initialized()``.
    """
    if jax.distributed.is_initialized():
        return
    if num_processes is not None and num_processes > 1:
        # An explicit multi-process request must never silently degrade:
        # let initialize() raise on a dead coordinator / late call.
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # Single-process environment (no coordinator to autodetect): run
        # locally.
        pass


def global_mesh() -> Mesh:
    """1-D ``rows`` mesh over every device of every host."""
    return make_mesh(jax.devices())


def host_row_ranges(n_rows: int, mesh: Mesh) -> list:
    """Per-local-device ``(device, start, stop)`` dataset row ranges.

    Derived from the ACTUAL device -> process map: mesh-flat position ``i``
    owns global rows ``[i * per_shard, (i + 1) * per_shard)`` (last ranges
    clamped to ``n_rows``), and this process is responsible for exactly the
    positions whose device it hosts — contiguous or not. This is the
    loading contract for :func:`fit_sharded_multihost`: pass the
    concatenation of these ranges' rows, in this order.
    """
    n_dev = mesh.devices.size
    per_shard = -(-n_rows // n_dev)  # ceil
    me = jax.process_index()
    return [
        (d, min(i * per_shard, n_rows), min((i + 1) * per_shard, n_rows))
        for i, d in enumerate(mesh.devices.flat)
        if d.process_index == me
    ]


def host_row_slice(n_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """[start, stop) of the dataset rows this process should load.

    Only valid when this process's shards are CONTIGUOUS in mesh-flat
    order; a non-contiguous process -> device layout raises instead of
    silently mis-assigning rows — use :func:`host_row_ranges` there.
    """
    ranges = host_row_ranges(n_rows, mesh)
    if not ranges:
        # A process outside a sub-mesh hosts no shard: it loads no rows.
        return 0, 0
    for (_, _, stop0), (_, start1, _) in zip(ranges, ranges[1:]):
        if start1 != stop0:
            raise ValueError(
                "This process's device shards are not contiguous in "
                "mesh-flat order; load per host_row_ranges() instead."
            )
    return ranges[0][1], ranges[-1][2]


def fit_sharded_multihost(
    config: CVConfig,
    mesh: Mesh,
    host_X: np.ndarray,
    host_Y: Optional[np.ndarray] = None,
    host_weights: Optional[np.ndarray] = None,
    *,
    n_rows_global: Optional[int] = None,
) -> FitState:
    """Sharded fit from host-local row blocks.

    Each process passes only ITS rows — the concatenation of its
    :func:`host_row_ranges` ranges, in that order; the global row-sharded
    arrays are assembled per-device with
    ``jax.make_array_from_single_device_arrays`` (correct for ANY
    process -> device layout, contiguous or not) and the standard sharded
    fit runs on top. With one process this is exactly :func:`fit_sharded`.
    """
    if jax.process_count() == 1:
        return fit_sharded(config, mesh, host_X, host_Y, host_weights)

    n_dev = mesh.devices.size
    if n_rows_global is None:
        raise ValueError("n_rows_global is required with multiple processes.")
    per_shard = -(-n_rows_global // n_dev)
    n_padded = per_shard * n_dev
    ranges = host_row_ranges(n_rows_global, mesh)
    n_local = sum(stop - start for _, start, stop in ranges)

    dtype = config.dtype
    row = NamedSharding(mesh, P(ROWS, None))

    # Host-side pre-flight (the single-process branch validates inside
    # fit(); here fit runs with validate=False under jit, so the check
    # must happen on the host blocks). The verdict is agreed COLLECTIVELY:
    # raising on only the process that owns the bad rows would leave the
    # others blocked in the sharded fit's psum until the collective
    # timeout — every process must raise, or none.
    local_bad = bool(
        host_weights is not None and np.any(np.asarray(host_weights) < 0)
    )
    from jax.experimental import multihost_utils

    any_bad = bool(np.any(
        multihost_utils.process_allgather(np.array([local_bad]))
    ))
    if any_bad:
        raise ValueError("Weights must be non-negative.")

    def build(host_block, pad_value=0.0):
        if host_block is None:
            return None
        hb = np.asarray(host_block, dtype=dtype)
        if hb.ndim == 1:
            hb = hb[:, None]
        if hb.shape[0] != n_local:
            raise ValueError(
                f"host block has {hb.shape[0]} rows; this process owns "
                f"{n_local} (load per host_row_ranges())."
            )
        shards, off = [], 0
        for dev, start, stop in ranges:
            blk = hb[off : off + (stop - start)]
            off += stop - start
            if blk.shape[0] < per_shard:  # zero-pad a clamped tail shard
                blk = np.concatenate([
                    blk,
                    np.full((per_shard - blk.shape[0], hb.shape[1]),
                            pad_value, dtype),
                ])
            shards.append(jax.device_put(blk, dev))
        return jax.make_array_from_single_device_arrays(
            (n_padded, hb.shape[1]), row, shards
        )

    # Zero-weight padding preserves all statistics exactly (see
    # distributed._pad_rows); unweighted data gets unit weights with zero
    # pads for the same reason.
    w = host_weights
    if w is None:
        w = np.ones(n_local, dtype)
    Xg = build(host_X)
    Yg = build(host_Y)
    wg = build(w, pad_value=0.0)

    from functools import partial

    from ..core.fit import fit as _fit
    from .distributed import _sharded_fit_program, fit_out_spec

    rep = NamedSharding(mesh, P())
    shape_state = jax.eval_shape(partial(_fit, config, validate=False),
                                 Xg, Yg, wg)
    return _sharded_fit_program(
        config, fit_out_spec(shape_state, row, rep)
    )(Xg, Yg, wg)
