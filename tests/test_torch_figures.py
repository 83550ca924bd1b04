"""Port parity: the figure tools (``plot_campaign_figures``,
``plot_ablations_combined``) against ``scripts/plot_campaign_figures.py``
and ``scripts/plot_ablations_combined.py``, on the committed ``docs/``
artifacts.

The regret-grid figures drawn by the port's ``grouped_results`` hold the
same statistics as the JAX package's on the committed 128-study curves:
every drawn line's and band's coordinates agree to rtol 1e-12, for the
robust statistics (median and quartiles) and for mean +- SEM.  The
ablation figure reads the same rows as the JAX script and draws them;
both tools write their files into ``tmp_path``.
"""

import importlib.util
import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from scamlgp_tpu_torch import plot_ablations_combined as tabl  # noqa: E402
from scamlgp_tpu_torch import plot_campaign_figures as tfig  # noqa: E402
from tests.torch_threads import one_thread  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
CELLS = {"branin": tfig.CELLS["branin"]}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drawn(fig) -> list:
    """Every line's and filled band's coordinates, axis by axis."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), float))
        for coll in ax.collections:
            out.extend(np.asarray(p.vertices, float)
                       for p in coll.get_paths())
    return out


@pytest.mark.parametrize("robust", [True, False],
                         ids=["median_25quant75", "mean_sem"])
def test_grouped_results_statistics_match(robust):
    from scamlgp_tpu.benchmarking.configurations.styles import (
        OPTIMIZER_STYLES,
    )
    from scamlgp_tpu.benchmarking.plotting import grouped_results
    from scamlgp_tpu.bo.core import Objective

    jmod = _script("plot_campaign_figures")
    runs, groups = [], {}
    for stem, title in CELLS["branin"]:
        run, config = jmod.regrets_to_runs(
            np.load(os.path.join(DOCS, stem + ".npy")), stem)
        runs.append(run)
        groups[title] = [config]
    jfig = grouped_results(runs, optimizer_styles=OPTIMIZER_STYLES,
                           groups=groups, robust_statistics=robust,
                           use_regrets=True, use_benchmark_optimum=True,
                           objective=Objective("loss", False))
    figs = tfig.figures(CELLS, DOCS, robust)
    stats = "median_25quant75" if robust else "mean_sem"
    assert sorted(figs) == sorted([f"branin_tpu_128studies_{stats}",
                                   f"figure_synthetic_tpu_{stats}"])
    ours, ref = _drawn(figs[f"branin_tpu_128studies_{stats}"]), _drawn(jfig)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    plt.close("all")


def test_campaign_figures_are_written(tmp_path, capsys):
    """With one of CELLS' curves under ``--docs``, its benchmark's grid
    and the combined panel, in both statistics; the others are skipped."""
    stem = CELLS["branin"][0][0]
    docs = tmp_path / "docs"
    docs.mkdir()
    np.save(docs / (stem + ".npy"), np.load(os.path.join(DOCS,
                                                         stem + ".npy")))
    written = tfig.main(["--docs", str(docs), "--out-dir",
                         str(tmp_path / "out")])
    names = sorted(os.path.basename(p) for p in written)
    assert names == sorted(
        f"{b}_{s}.pdf" for b in ("branin_tpu_128studies",
                                 "figure_synthetic_tpu")
        for s in ("median_25quant75", "mean_sem"))
    assert all(os.path.getsize(p) > 0 for p in written)
    assert capsys.readouterr().out.count("skip (missing)") == 2 * 5
    plt.close("all")


def test_ablation_rows_match_and_figure_is_written(tmp_path):
    jmod = _script("plot_ablations_combined")
    assert [p[:3] for p in tabl.PANELS] == [p[:3] for p in jmod.PANELS]
    for (_, _, main_f, tails), (_, _, jmain, jtails) in zip(tabl.PANELS,
                                                            jmod.PANELS):
        assert tails == jtails
        rows = tabl.load_rows(main_f, tails)
        assert rows and rows == jmod.load_rows(jmain, jtails)
    out = tabl.main(["--out", str(tmp_path / "abl.pdf")])
    assert os.path.getsize(out) > 0
    fig, drew = tabl.draw()
    assert drew == 4
    for ax, (_, _, main_f, tails) in zip(fig.axes, tabl.PANELS):
        rows = tabl.load_rows(main_f, tails)
        np.testing.assert_array_equal(
            ax.get_lines()[0].get_ydata(),
            [r["avg_cum_regret_mean"] for r in rows])
    plt.close("all")
