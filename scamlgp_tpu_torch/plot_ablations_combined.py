"""The combined 2 x 2 ablation figure from ablation rows (port of
``scripts/plot_ablations_combined.py``).

Draws the reference's combined cumulative-regret ablation figure: the
average cumulative simple regret (mean +- SEM) against the number of
meta-tasks M and of points per task N_m, for Branin and Hartmann6D, on
log-log axes, from the committed JSON rows of ``scripts/run_ablation.py``
(``{"rows": [{"value", "avg_cum_regret_mean", "avg_cum_regret_sem",
...}]}``; ``scamlgp_tpu_torch.ablation`` writes the same).  Each panel
reads a main file and its tail files under ``docs/``; a later file's row
wins where two give the same value.  A CPU tool: matplotlib is imported
by ``draw`` only (the card's machine has none).  ``--out`` defaults to
``build/figures/ablations_summary.pdf``, so that the committed figure in
``docs/`` stays as it is.

    python -m scamlgp_tpu_torch.plot_ablations_combined [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")

#: (title, x label, main file, tail files: later files win on a value)
PANELS = [
    ("Branin", "Num. meta-tasks ($M$)",
     "branin_ablation_tasks_tpu.json",
     ["branin_ablation_tasks_m64_tpu.json",
      "branin_ablation_tasks_tpu_s128.json"]),
    ("Branin", "Num. obs. per task ($N_m$)",
     "branin_ablation_points_tpu.json",
     ["branin_ablation_points_n256_tpu.json",
      "branin_ablation_points_tpu_s128.json"]),
    ("Hartmann 6D", "Num. meta-tasks ($M$)",
     "hm6_ablation_tasks_tpu.json",
     ["hm6_ablation_tasks_tpu_s128.json"]),
    ("Hartmann 6D", "Num. obs. per task ($N_m$)",
     "hm6_ablation_points_tpu.json",
     ["hm6_ablation_points_tpu_s128.json"]),
]


def load_rows(main: str, tails) -> list:
    """The rows of ``main`` and ``tails`` under ``docs/`` by value, a later
    file's row replacing an earlier one's, sorted by value."""
    rows = {}
    for name in [main] + list(tails):
        path = os.path.join(DOCS, name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            art = json.load(fh)
        for r in art.get("rows", []):
            rows[r["value"]] = r
    return [rows[v] for v in sorted(rows)]


def draw():
    """(figure, panels drawn)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rc("font", family="serif")
    fig, axs = plt.subplots(2, 2, figsize=(6.75, 4), sharey="row",
                            sharex="col")
    drew = 0
    col_xs = {}
    for i, (ax, (title, _, main_f, tails)) in enumerate(
            zip(axs.flatten(), PANELS)):
        rows = load_rows(main_f, tails)
        ax.set_title(title, fontsize=9)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.grid(True, which="both", alpha=0.25, linewidth=0.5)
        if not rows:
            ax.text(0.5, 0.5, "(pending)", transform=ax.transAxes,
                    ha="center", fontsize=8)
            continue
        xs = [r["value"] for r in rows]
        ax.errorbar(xs, [r["avg_cum_regret_mean"] for r in rows],
                    yerr=[r["avg_cum_regret_sem"] for r in rows], marker="o",
                    markersize=3, linewidth=1.2, capsize=2,
                    label="ScaML-GP (TPU)")
        ax.minorticks_off()
        col_xs.setdefault(i % 2, set()).update(xs)
        drew += 1
    # sharex="col": each column's ticks are the union of its panels' values
    # (a panel's own set_xticks would overwrite the other's)
    for col, xs_union in col_xs.items():
        xs_sorted = sorted(xs_union)
        for ax in axs[:, col]:
            ax.set_xticks(xs_sorted)
            ax.set_xticklabels([str(x) for x in xs_sorted], fontsize=7)
            ax.minorticks_off()
    axs[0, 0].set_ylabel("Cum. regret")
    axs[1, 0].set_ylabel("Cum. regret")
    axs[1, 0].set_xlabel(PANELS[2][1])
    axs[1, 1].set_xlabel(PANELS[3][1])
    handles, labels = axs[0, 0].get_legend_handles_labels()
    if handles:
        fig.legend(handles[:1], labels[:1], loc="lower center", ncol=1,
                   frameon=False, fontsize=8)
    fig.tight_layout(rect=(0, 0.06, 1, 1))
    return fig, drew


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        "build", "figures", "ablations_summary.pdf"))
    args = ap.parse_args(argv)
    fig, drew = draw()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out)
    print(f"wrote {args.out} ({drew}/4 panels populated)")
    return args.out


if __name__ == "__main__":
    main()
