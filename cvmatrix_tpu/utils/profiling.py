"""Profiling/observability helpers (SURVEY.md §5: the reference has only
wall-clock timing; this adds profiler traces and GB/s counters).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Iterator, Optional

import jax

__all__ = ["card_description", "trace", "Stopwatch"]


def card_description() -> str:
    """The GPU's name and power limit, as ``nvidia-smi`` reports them.

    A card may be capped below its rated power and then runs slower under
    load, so every recorded time carries this line. Returns the error text
    instead when ``nvidia-smi`` cannot be run.
    """
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc={out.returncode}): {out.stderr.strip()}"
    return out.stdout.strip()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``jax.profiler`` trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Stopwatch:
    """Wall-clock timer with optional byte counter -> achieved GB/s."""

    def __init__(self, bytes_accessed: Optional[int] = None) -> None:
        self.bytes_accessed = bytes_accessed
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0

    @property
    def gbps(self) -> Optional[float]:
        if self.bytes_accessed is None or not self.elapsed:
            return None
        return self.bytes_accessed / self.elapsed / 1e9
