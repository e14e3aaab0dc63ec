"""Reference-compatible object facade over the functional core.

A user of the reference library (``cvmatrix.CVMatrix``,
``/root/reference/cvmatrix/cvmatrix.py:99``) can switch to this class with the
same constructor knobs and the same four public per-fold methods returning the
same ``(matrices, (X_mean, X_std, Y_mean, Y_std))`` structures. Differences:

- The engine is JAX-only (the reference's numpy/jax backend resolver
  collapses — SURVEY.md §2); ``backend`` must be ``"jax"``.
- ``copy`` is accepted for signature parity but is a no-op: JAX arrays are
  immutable, so the undefined-behavior hazard the reference documents for
  ``copy=False`` cannot arise.
- Methods are pure functions of closed-over fitted state, so
  ``jax.jit(jax.vmap(cvm.training_XTX_XTY))`` works exactly as in the
  reference's JAX backend (ref ``examples/training_matrices_jax.py:56``) —
  plus an optional ``mask`` argument for padded heterogeneous fold batches.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import CVConfig
from ..core import fold as _fold
from ..core.fit import fit as _fit_fn

# One compiled fit per (config, shapes): validation runs host-side first, so
# the jitted body skips its (trace-incompatible) eager weight check.
_fit_jitted = jax.jit(
    lambda config, X, Y, w: _fit_fn(config, X, Y, w, validate=False),
    static_argnums=(0,),
)
from ..core.state import FitState
from ..utils.tracing import ensure_x64

__all__ = ["CVMatrix"]


class CVMatrix:
    """Fast cross-validation training-matrix engine (Engstrøm–Jensen).

    Computes the dataset-wide ``X^T W X`` / ``X^T W Y`` once at ``fit`` time,
    then derives every fold's *training-set* matrices by downdating the
    validation block and applying weighted centering/scaling corrections as
    rank-one updates — per-fold cost independent of training-set size.
    """

    def __init__(
        self,
        center_X: bool = True,
        center_Y: bool = True,
        scale_X: bool = True,
        scale_Y: bool = True,
        ddof: int = 1,
        dtype=np.float64,
        copy: bool = True,
        backend: Literal["jax"] = "jax",
        matmul_mode: str = "auto",
    ) -> None:
        if backend != "jax":
            raise ValueError(
                f"Invalid backend: {backend!r}. This engine is JAX-native; "
                "only backend='jax' is supported (it runs on CPU and GPU)."
            )
        self.config = CVConfig(
            center_X=center_X,
            center_Y=center_Y,
            scale_X=scale_X,
            scale_Y=scale_Y,
            ddof=ddof,
            dtype=dtype,
            matmul_mode=matmul_mode,
        )
        # Honor a requested 64-bit dtype (ref cvmatrix.py:181-186).
        ensure_x64(self.config.dtype)
        self.copy = copy
        self.backend = backend
        self.state: Optional[FitState] = None

    # ---- constructor-knob passthroughs (reference attribute parity) ----

    @property
    def center_X(self) -> bool:
        return self.config.center_X

    @property
    def center_Y(self) -> bool:
        return self.config.center_Y

    @property
    def scale_X(self) -> bool:
        return self.config.scale_X

    @property
    def scale_Y(self) -> bool:
        return self.config.scale_Y

    @property
    def ddof(self) -> int:
        return self.config.ddof

    @property
    def dtype(self):
        return self.config.dtype

    @property
    def resolution(self) -> float:
        return self.config.resolution

    # ---- fitted-state passthroughs -------------------------------------

    def _state_attr(self, name):
        return None if self.state is None else getattr(self.state, name)

    @property
    def X(self):
        return self._state_attr("X")

    @property
    def Y(self):
        return self._state_attr("Y")

    @property
    def WX(self):
        return self._state_attr("WX")

    @property
    def WY(self):
        return self._state_attr("WY")

    @property
    def weights(self):
        return self._state_attr("weights")

    @property
    def XTX(self):
        return self._state_attr("XTX")

    @property
    def XTY(self):
        return self._state_attr("XTY")

    @property
    def sum_X(self):
        return self._state_attr("sum_X")

    @property
    def sum_Y(self):
        return self._state_attr("sum_Y")

    @property
    def sum_sq_X(self):
        return self._state_attr("sum_sq_X")

    @property
    def sum_sq_Y(self):
        return self._state_attr("sum_sq_Y")

    @property
    def sum_w(self):
        return self._state_attr("sum_w")

    @property
    def num_nonzero_w(self):
        return self._state_attr("num_nonzero_w")

    @property
    def N(self) -> Optional[int]:
        return None if self.state is None else self.state.N

    @property
    def K(self) -> Optional[int]:
        return None if self.state is None else self.state.K

    @property
    def M(self) -> Optional[int]:
        return None if self.state is None else self.state.M

    # ---- public API ------------------------------------------------------

    def fit(self, X, Y=None, weights=None) -> "CVMatrix":
        """Load data and compute dataset-wide products/statistics.

        Mirrors ref ``fit`` (:207-328); raises ``ValueError`` for negative
        weights. Returns ``self`` for chaining. The compute is jitted (one
        compile per config + input shapes); validation runs eagerly first.
        """
        w = None
        if weights is not None:
            w = jnp.asarray(weights, dtype=self.config.dtype)
            if w.ndim == 1:
                w = w.reshape(-1, 1)
            if bool(jnp.any(w < 0)):
                raise ValueError("Weights must be non-negative.")
        self.state = _fit_jitted(
            self.config,
            jnp.asarray(X, dtype=self.config.dtype),
            None if Y is None else jnp.asarray(Y, dtype=self.config.dtype),
            w,
        )
        return self

    def _require_fit(self) -> FitState:
        if self.state is None:
            raise ValueError("fit() must be called before per-fold methods.")
        return self.state

    def training_XTX(self, validation_indices, mask=None):
        """Training ``X^T W X`` for one fold (ref :330-383)."""
        return _fold.training_XTX(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_XTY(self, validation_indices, mask=None):
        """Training ``X^T W Y`` for one fold (ref :385-449)."""
        return _fold.training_XTY(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_XTX_XTY(self, validation_indices, mask=None):
        """Training ``X^T W X`` and ``X^T W Y`` for one fold (ref :451-517)."""
        return _fold.training_XTX_XTY(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_statistics(self, validation_indices, mask=None) -> Tuple:
        """Training means/stds only (ref :519-574)."""
        return _fold.training_statistics(
            self.config, self._require_fit(), validation_indices, mask
        )

    def _training_matrices(self, return_XTX, return_XTY, validation_indices,
                           mask=None):
        """Reference-private-API parity shim (ref :754)."""
        return _fold.training_matrices(
            self.config,
            self._require_fit(),
            validation_indices,
            mask,
            return_XTX=return_XTX,
            return_XTY=return_XTY,
        )

    def cross_validate_reduce(self, partitioner, *, reduce_fn, **kw):
        """Device-resident sweep over ALL folds of ``partitioner``.

        One compiled program computes every fold's training matrices and
        immediately consumes them with
        ``reduce_fn(matrices, stats)`` — only the reductions come back.
        Returns ``(fold_keys, stacked_reductions)``. No reference
        equivalent (the reference leaves fold batching to the caller); see
        :func:`cvmatrix_tpu.models.sweep.cross_validate_reduce`.
        """
        from .sweep import cross_validate_reduce as _cvr

        state = self._require_fit()
        keys, idx, mask = partitioner.padded_batches()
        return keys, _cvr(
            self.config, state, idx, mask, reduce_fn=reduce_fn, **kw
        )
