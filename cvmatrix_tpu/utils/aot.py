"""Ahead-of-time program artifacts: compile once, ship to a fleet.

The persistent compilation cache (:mod:`cvmatrix_tpu.utils.cache`) removes
repeat compiles on ONE machine; this module removes repeat traces across
machines. ``export_program`` runs the trace + platform lowering (StableHLO)
for a pinned platform set and writes a self-contained artifact;
``load_program`` restores a callable on any host whose runtime platform is in
that set. The lowering is platform-specific but needs no device: a CPU-only
build host can export a ``cuda`` artifact. No reference equivalent (the
reference relies on JAX's in-process jit cache only; its published cold-JIT
cost is 23 s on GPU, ref ``benchmark_results_jax.csv:45``).

The artifact embeds the argument tree structure/shapes/dtypes and the
serialization is versioned by JAX itself; a shape or dtype mismatch at call
time raises with the expected spec. Sharded layouts survive export
(jax.export carries shardings for multi-device programs).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import jax

__all__ = ["export_program", "load_program"]

_MAGIC = b"CVMTPU-AOT\x00"


def _register_state_serialization() -> None:
    # jax.export serializes the calling convention's pytree structure, and
    # custom nodes need an explicit name + auxdata codec. FitState carries
    # no static auxdata (every field is an array or None), so the codec is
    # trivial. Idempotent: repeat registration raises, and module bodies
    # run once per process anyway — the guard covers importlib.reload.
    from ..core.state import FitState

    try:
        jax.export.register_pytree_node_serialization(
            FitState,
            serialized_name="cvmatrix_tpu.core.state.FitState",
            serialize_auxdata=lambda aux: b"",
            deserialize_auxdata=lambda blob: (),
        )
    except ValueError:
        pass


_register_state_serialization()


def export_program(
    fn: Callable,
    example_args: Sequence,
    path: str,
    *,
    platforms: Optional[Sequence[str]] = None,
    static_argnums: Sequence[int] = (),
) -> int:
    """Trace + lower ``fn(*example_args)`` for ``platforms``; write to ``path``.

    ``platforms`` defaults to the running backend's platform. ``fn`` is
    jitted if it is not already a jitted computation. Returns the artifact
    size in bytes. The on-device machine-code compile still happens once at
    first call on each runtime, served by the persistent cache thereafter.
    """
    jitted = fn if hasattr(fn, "lower") else jax.jit(
        fn, static_argnums=tuple(static_argnums)
    )
    exp = jax.export.export(
        jitted, platforms=None if platforms is None else list(platforms)
    )(*example_args)
    payload = exp.serialize()
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(payload)
    os.replace(tmp, path)  # atomic: a fleet puller never sees half a file
    return len(payload) + len(_MAGIC)


def load_program(path: str) -> Callable:
    """Restore an :func:`export_program` artifact as a callable.

    The callable enforces the exported shapes/dtypes and runs on the current
    default device (which must be one of the artifact's pinned platforms).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise ValueError(
            f"{path} is not a cvmatrix_tpu AOT artifact (bad header)"
        )
    exp = jax.export.deserialize(bytearray(blob[len(_MAGIC):]))
    return exp.call
