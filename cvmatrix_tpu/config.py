"""Static configuration for the fast cross-validation engine.

The reference library (``/root/reference/cvmatrix/cvmatrix.py:157-206``) carries
its eight knobs (``center_X/center_Y/scale_X/scale_Y, ddof, dtype, copy,
backend``) as mutable instance attributes. Here they live in a frozen, hashable
dataclass so the per-fold functions are pure functions of ``(config, state,
indices)`` and the config can be closed over / passed as a static argument to
``jax.jit`` without retracing hazards.

Addition with no reference equivalent:

- ``matmul_mode``: how the ``A^T @ B`` contractions are lowered. ``"auto"``
  and ``"native"`` use the backend's float64 ``dot`` (cuBLAS DGEMM on a GPU);
  ``"exact"`` routes them through the Ozaki-style int8-slice matmul in
  :mod:`cvmatrix_tpu.ops.precise`, accurate to ~2^-53 relative whatever the
  backend's float64 product rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["CVConfig"]


@dataclasses.dataclass(frozen=True)
class CVConfig:
    """Immutable preprocessing/precision configuration.

    Mirrors the constructor knobs of the reference engine
    (``cvmatrix/cvmatrix.py:157-173``): the four centering/scaling booleans
    (16 combinations), ``ddof``, and ``dtype``. ``copy`` and ``backend`` from
    the reference do not apply (JAX always owns device buffers; the backend is
    JAX-only by design — see SURVEY.md §2 "Backend resolver").

    >>> import numpy as np
    >>> cfg = CVConfig(center_X=True, center_Y=False, scale_X=False,
    ...                scale_Y=False, ddof=0, dtype=np.float32)
    >>> cfg.dtype is np.float32
    True
    >>> CVConfig(dtype=np.int32)
    Traceback (most recent call last):
        ...
    ValueError: dtype must be a floating dtype, got dtype('int32').
    """

    center_X: bool = True
    center_Y: bool = True
    scale_X: bool = True
    scale_Y: bool = True
    ddof: int = 1
    dtype: Any = np.float64
    # "auto" | "exact" | "native"
    matmul_mode: str = "auto"

    def __post_init__(self) -> None:
        dt = np.dtype(self.dtype)
        if dt.kind != "f":
            raise ValueError(f"dtype must be a floating dtype, got {dt!r}.")
        object.__setattr__(self, "dtype", dt.type)
        if self.matmul_mode not in ("auto", "exact", "native"):
            raise ValueError(
                f"Invalid matmul_mode: {self.matmul_mode!r}. "
                "Must be 'auto', 'exact', or 'native'."
            )

    # ---- derived facts (mirror the conditional-computation rules of the
    # reference fit step, cvmatrix/cvmatrix.py:1219-1243) -------------------

    @property
    def resolution(self) -> float:
        """Std clamp threshold: stds <= resolution are replaced by 1.

        Matches ``np.finfo(dtype).resolution * 10``
        (``cvmatrix/cvmatrix.py:187``).
        """
        return float(np.finfo(self.dtype).resolution * 10)

    @property
    def any_stats(self) -> bool:
        """Whether fit must compute sum_w / num_nonzero_w (ref :1223)."""
        return self.center_X or self.center_Y or self.scale_X or self.scale_Y

    @property
    def needs_sum_X(self) -> bool:
        """ref cvmatrix.py:1230."""
        return self.center_X or self.center_Y or self.scale_X

    @property
    def needs_sum_Y(self) -> bool:
        """ref cvmatrix.py:1232 (additionally requires Y to be present)."""
        return self.center_X or self.center_Y or self.scale_Y

    @property
    def needs_WY(self) -> bool:
        """ref cvmatrix.py:1206 (weighted case only)."""
        return self.center_X or self.center_Y or self.scale_Y
