"""Plot harness smoke tests: each figure family renders from a tiny CSV.

The reference publishes four benchmark figure families
(ref ``benchmarks/plot_benchmark.py``); these tests pin that our
counterpart functions produce files from representative rows (pure
pandas/matplotlib — no device work).
"""

import importlib.util
import os
import sys

import pandas as pd
import pytest

_SPEC = importlib.util.spec_from_file_location(
    "plot_benchmark",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "plot_benchmark.py"),
)
plot_benchmark = importlib.util.module_from_spec(_SPEC)
sys.modules["plot_benchmark"] = plot_benchmark
_SPEC.loader.exec_module(plot_benchmark)


def _rows():
    rows = []
    for mode in ("nojit", "coldjit", "warmjit"):
        for p in (10, 1000, 100000):
            rows.append({
                "model": f"CVMatrix-gpu-{mode}", "weights": True,
                "P": p, "N": 100000, "K": 500, "M": 10,
                "center_X": True, "center_Y": True,
                "scale_X": True, "scale_Y": True,
                "time": 1.0 / p + (10.0 if mode == "coldjit" else 0.1),
                "fit_time": 0.1, "folds_time": 0.5,
                "folds_per_sec": p, "gbps": 300.0, "version": "t",
            })
    rows.append({
        "model": "NaiveOracle", "weights": True, "P": 10, "N": 100000,
        "K": 500, "M": 10, "center_X": True, "center_Y": True,
        "scale_X": True, "scale_Y": True, "time": 50.0, "fit_time": "",
        "folds_time": "", "folds_per_sec": "", "gbps": None, "version": "t",
    })
    return pd.DataFrame(rows)


@pytest.mark.parametrize("fn,name", [
    (plot_benchmark.plot_vs_naive, "vs_naive.png"),
    (plot_benchmark.plot_combos, "combos.png"),
    (plot_benchmark.plot_roofline, "roofline.png"),
    (plot_benchmark.plot_jit_modes, "jit_modes.png"),
])
def test_figure_families_render(tmp_path, fn, name):
    out = str(tmp_path / name)
    fn(_rows(), out)
    assert os.path.exists(out) and os.path.getsize(out) > 1000


def test_latest_per_config_selector(capsys):
    """Appended re-measurements win; stale date mixes warn.

    The grid CSV is append-only across rounds (``benchmarks/README.md``);
    figures must come from an EXPLICIT latest-per-config frame, not
    implicit row order (VERDICT r3 weak #7).
    """
    base = _rows().assign(date="2026-08-01")
    # Re-measure ONE config on a later date with a different time.
    rerun = base.iloc[[0]].assign(date="2026-08-18", time=0.123)
    df = pd.concat([base, rerun], ignore_index=True)
    picked = plot_benchmark.latest_per_config(df)
    # one row per config key survives
    assert len(picked) == len(base)
    key = [c for c in plot_benchmark.CONFIG_KEY if c in df.columns]
    m = picked.merge(rerun[key], on=key)
    assert list(m.time) == [0.123] and list(m.date) == ["2026-08-18"]
    # the mixed-dates warning names both dates
    err = capsys.readouterr().err
    assert "2026-08-01" in err and "2026-08-18" in err

    # same-date re-runs: appended row order breaks the tie
    dup = pd.concat([base, base.iloc[[3]].assign(time=9.9)],
                    ignore_index=True)
    picked = plot_benchmark.latest_per_config(dup, warn=False)
    assert len(picked) == len(base)
    m = picked.merge(base.iloc[[3]][key], on=key)
    assert list(m.time) == [9.9]

    # no date column at all: pure row order, no crash
    picked = plot_benchmark.latest_per_config(
        dup.drop(columns=["date"]), warn=False)
    assert len(picked) == len(base)


def test_jit_modes_skips_single_mode(tmp_path):
    """With only warmjit rows the comparison figure is (correctly) skipped."""
    df = _rows()
    df = df[df.model.str.endswith("warmjit") | (df.model == "NaiveOracle")]
    out = str(tmp_path / "skip.png")
    plot_benchmark.plot_jit_modes(df, out)
    assert not os.path.exists(out)
