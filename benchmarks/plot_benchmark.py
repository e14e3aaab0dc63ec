"""Plot benchmark CSVs (counterpart of the reference's plot_benchmark.py).

Figure families:
  1. fast engine vs naive oracle over P (log-log)         -> *_vs_naive.png
  2. all preprocessing combinations over P                -> *_combos.png
  3. fold-phase achieved GB/s over P (with a bandwidth line when one is
     given)                                               -> *_roofline.png
     (no reference equivalent)
  4. JIT-mode comparison (nojit / coldjit / warmjit) over P -> *_jit_modes.png
     (counterpart of the reference's jit-mode figure family,
     ref ``benchmarks/plot_benchmark.py:308-407``)

Usage: python benchmarks/plot_benchmark.py [results.csv]
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd

FLAG_COLS = ["center_X", "center_Y", "scale_X", "scale_Y"]

# One benchmark configuration = one curve point. The grid CSV is
# append-only across measurement rounds, so several rows can share a key;
# exactly one (the latest) may feed a figure.
CONFIG_KEY = ["model", "weights", "P", "N", "K", "M"] + FLAG_COLS


def latest_per_config(df, warn=True):
    """Keep the newest row per benchmark configuration, explicitly.

    Newest = max ``date`` (appended row order breaks same-day ties; rows
    without a date sort oldest). When the SURVIVING frame still mixes
    dates — i.e. some configurations were last measured in an older round
    than others — emit a warning naming the stale dates, so a figure
    silently blending rounds is visible in the plot logs.
    """
    df = df.reset_index(drop=True)
    order = df.index.to_series(name="_order")
    date = (df["date"].fillna("") if "date" in df.columns
            else pd.Series("", index=df.index)).astype(str)
    key = [c for c in CONFIG_KEY if c in df.columns]
    picked = (
        df.assign(_order=order, _date=date)
        .sort_values(["_date", "_order"])
        .groupby(key, dropna=False, as_index=False)
        .last()
    )
    # Baseline anchors (the naive oracle: host NumPy recompute of the
    # reference semantics) are version-independent by construction — their
    # timings do not move with the package under measurement, so an older
    # date there is not staleness. The warning exists to catch figures
    # silently blending stale FAST-ENGINE rounds.
    engine = ~picked["model"].astype(str).str.startswith("NaiveOracle")
    dates = sorted(d for d in picked.loc[engine, "_date"].unique() if d)
    if warn and len(dates) > 1:
        n_stale = int(
            (picked.loc[engine, "_date"] != dates[-1]).sum()
        )
        print(
            f"latest_per_config: figure mixes measurement dates {dates} — "
            f"{n_stale} of {int(engine.sum())} engine configs were not "
            "re-measured on the newest date",
            file=sys.stderr,
        )
    return picked.drop(columns=["_order", "_date"])


def flag_label(row):
    return "".join("T" if row[c] in (True, "True") else "F" for c in FLAG_COLS)


def plot_vs_naive(df, out):
    fast = df[df.model.str.startswith("CVMatrix")]
    naive = df[df.model.str.startswith("NaiveOracle")]
    if naive.empty:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    for (label), g in fast.assign(flags=fast.apply(flag_label, axis=1)).groupby(
        "flags"
    ):
        g = g.sort_values("P")
        ax.loglog(g.P, g.time, marker="o", label=f"fast {label}")
    for (label, extrap), g in naive.assign(
        flags=naive.apply(flag_label, axis=1),
        extrap=naive.model.str.endswith("-extrapolated"),
    ).groupby(["flags", "extrap"]):
        g = g.sort_values("P")
        # Extrapolated points (subset-timed, linearly scaled to P folds)
        # render as hollow triangles on a dotted line so measured and
        # projected can't be conflated ('x' is line-art: a facecolor
        # tweak alone would be invisible).
        if extrap:
            ax.loglog(g.P, g.time, marker="^", markerfacecolor="none",
                      ls=":", label=f"naive {label} (extrapolated)")
        else:
            ax.loglog(g.P, g.time, marker="x", ls="--",
                      label=f"naive {label}")
    ax.set_xlabel("P (folds)")
    ax.set_ylabel("total cross-validation time (s)")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


def plot_combos(df, out):
    fast = df[df.model.str.startswith("CVMatrix")]
    if fast.empty:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    fast = fast.assign(flags=fast.apply(flag_label, axis=1))
    for (flags, w), g in fast.groupby(["flags", "weights"]):
        g = g.sort_values("P")
        ax.loglog(g.P, g.time, marker="o", alpha=0.7,
                  label=f"{flags} {'w' if w in (True, 'True') else 'unw'}")
    ax.set_xlabel("P (folds)")
    ax.set_ylabel("total cross-validation time (s)")
    ax.legend(fontsize=7, ncol=2)
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


def plot_roofline(df, out, hbm_gbps=None):
    fast = df[df.model.str.startswith("CVMatrix") & df.gbps.notna()]
    if fast.empty:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    fast = fast.assign(flags=fast.apply(flag_label, axis=1))
    for flags, g in fast.groupby("flags"):
        g = g.sort_values("P")
        ax.semilogx(g.P, g.gbps, marker="o", label=flags)
    if hbm_gbps is not None:
        ax.axhline(hbm_gbps, color="k", ls=":", label="HBM roofline")
    ax.set_xlabel("P (folds)")
    ax.set_ylabel("fold-phase achieved GB/s")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


def plot_jit_modes(df, out):
    """nojit vs coldjit vs warmjit total time over P (per flag combo).

    The mode is the trailing ``-{mode}`` token of the model column (see
    ``benchmark.py:run_cvmatrix``). The figure answers the reference's
    jit-modes question — what JIT costs you cold and buys you warm — for
    this engine (ref ``benchmarks/plot_benchmark.py:308-407``).
    """
    fast = df[df.model.str.startswith("CVMatrix")].copy()
    if fast.empty:
        return
    fast["mode"] = fast.model.str.rsplit("-", n=1).str[-1]
    modes = [m for m in ("nojit", "coldjit", "aotcold", "warmjit")
             if (fast["mode"] == m).any()]
    if len(modes) < 2:
        return  # nothing to compare
    fast["flags"] = fast.apply(flag_label, axis=1)
    style = {"nojit": dict(ls=":", marker="x"),
             "coldjit": dict(ls="--", marker="s"),
             "aotcold": dict(ls="-.", marker="d"),
             "warmjit": dict(ls="-", marker="o")}
    fig, ax = plt.subplots(figsize=(6, 6))
    for (mode, flags), g in fast.groupby(["mode", "flags"]):
        if mode not in style:
            continue
        g = g.sort_values("P")
        ax.loglog(g.P, g.time, alpha=0.8, label=f"{mode} {flags}",
                  **style[mode])
    ax.set_xlabel("P (folds)")
    ax.set_ylabel("total cross-validation time (s)")
    ax.legend(fontsize=7, ncol=2)
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out)


if __name__ == "__main__":
    csv = sys.argv[1] if len(sys.argv) > 1 else "benchmark_results.csv"
    df = latest_per_config(pd.read_csv(csv))
    base = os.path.splitext(csv)[0]
    plot_vs_naive(df, base + "_vs_naive.png")
    plot_combos(df, base + "_combos.png")
    plot_roofline(df, base + "_roofline.png")
    plot_jit_modes(df, base + "_jit_modes.png")
