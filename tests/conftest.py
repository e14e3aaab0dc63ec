"""Test environment: CPU-only JAX with 8 virtual devices and 64-bit mode.

Tests run on the CPU backend (true float64) so the numerical contract against
the NumPy oracle is checked at reference precision; the virtual 8-device mesh
exercises the multi-device sharding paths without GPUs. Mirrors the
reference's CI strategy of running the full suite on CPU
(ref ``.github/workflows/test_workflow.yml``).

The platform is forced via ``jax.config`` (the ``JAX_PLATFORMS`` variable is
read only when jax is imported, which may already have happened); XLA_FLAGS
is still read lazily at backend initialization, so the virtual-device flag
works from here.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert len(jax.devices()) == 8, (
    "tests expect 8 virtual CPU devices; backend was initialized too early"
)
