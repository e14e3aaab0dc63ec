"""The parts of ``chip_smoke.py`` a CPU can check: it refuses to run without
a GPU, its result line carries exactly the contract's keys, ``--four-cards``
selects only the mesh phase, and a tolerance miss fails the phase."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_cpu_with_nonzero_exit():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_last_line_has_exactly_the_contract_keys():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_four_cards_selects_only_the_mesh_phase():
    assert chip_smoke.select_phases(True) == [chip_smoke.phase_mesh]
    one = chip_smoke.select_phases(False)
    assert chip_smoke.phase_mesh not in one
    assert one == [chip_smoke.phase_headline, chip_smoke.phase_midband,
                   chip_smoke.phase_nir, chip_smoke.phase_exact]


def test_require_gpu_rejects_cpu_devices():
    import jax

    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("err", [2e-8, float("nan")])
def test_check_fails_on_tolerance_miss(err):
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check("case", err, 1e-8)


def test_oracle_digest_matches_engine_digest():
    """The on-card digest and its host twin pick the same four numbers."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    xtx, xty = rng.random((5, 5)), rng.random((5, 2))
    got = np.asarray(chip_smoke.digest((jnp.asarray(xtx), jnp.asarray(xty)),
                                       None))
    np.testing.assert_array_equal(got, chip_smoke.oracle_digest(xtx, xty))
