"""The reference's regret-grid figures from committed campaign regret
curves (port of ``scripts/plot_campaign_figures.py``).

Each ``<stem>.npy`` under ``--docs`` holds an (S, E) array of running-min
simple regrets of S studies.  Fed to the port's plotting layer
(``benchmarking/plotting.grouped_results``) as noise-free loss traces with
optimum 0, they give the per-benchmark grids of ``configurations/branin``,
``hartmann3`` and ``hartmann6`` and the combined ``figure_synthetic``
panel: ``compute_regrets`` is a running min, idempotent on a running-min
series, so the drawn statistics are the curves' own.  Both statistics are
drawn, the median with quartiles and the mean with its SEM.  A CPU tool:
matplotlib is imported by ``main`` only (the card's machine has none).

``CELLS`` names the 128-study curves that the JAX package committed.
``--out-dir`` defaults to ``build/figures``, so that the committed figures
in ``docs/`` stay as they are.

    python -m scamlgp_tpu_torch.plot_campaign_figures [--docs docs]
        [--out-dir build/figures]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

#: benchmark -> [(artifact stem, group title)]
CELLS = {
    "branin": [
        ("branin_t8_p32_n1_regrets_tpu_128studies",
         "Branin\n8 Tasks à 32 Points (σ_noise=1.0)"),
        ("branin_t32_p32_n1_regrets_tpu_128studies",
         "Branin\n32 Tasks à 32 Points (σ_noise=1.0)"),
    ],
    "hartmann3": [
        ("hm3_t8_p32_n01_regrets_tpu_128studies",
         "Hartmann3D\n8 Tasks à 32 Points (σ_noise=0.1)"),
        ("hm3_t32_p32_n01_regrets_tpu_128studies",
         "Hartmann3D\n32 Tasks à 32 Points (σ_noise=0.1)"),
    ],
    "hartmann6": [
        ("hm6_t8_p128_n01_regrets_tpu_128studies",
         "Hartmann6D\n8 Tasks à 128 Points (σ_noise=0.1)"),
        ("hm6_t32_p128_n01_regrets_tpu_128studies",
         "Hartmann6D\n32 Tasks à 128 Points (σ_noise=0.1)"),
    ],
}


def regrets_to_runs(regrets: np.ndarray, key: str):
    """An (S, E) regret array as one run of the study runner's result
    schema with optimum 0, and its ``Experiment``."""
    studies = [{
        "optimum": 0.0,
        "objectives": [{"name": "loss", "greater_is_better": False}],
        "evaluations": [
            {"configuration": {}, "objectives": {
                "loss (noisy)": float(v), "loss (noise free)": float(v)}}
            for v in row],
        "seed": int(s),
    } for s, row in enumerate(regrets)]
    config = Experiment(
        optimizer=ScaMLGPBO, benchmark={"cls": key, "kwargs": {}},
        n_evaluations=int(regrets.shape[1]),
        n_studies=int(regrets.shape[0]), compute="TPU")
    return {"experiment_config": config.__dict__, "studies": studies}, config


def figures(cells: dict, docs: str, robust: bool) -> dict:
    """name -> figure: one grid per benchmark with a curve under ``docs``,
    and the combined ``figure_synthetic`` panel of all of them."""
    from scamlgp_tpu_torch.benchmarking.configurations.styles import (
        OPTIMIZER_STYLES,
    )
    from scamlgp_tpu_torch.benchmarking.plotting import grouped_results

    stats = "median_25quant75" if robust else "mean_sem"
    kw = dict(optimizer_styles=OPTIMIZER_STYLES, robust_statistics=robust,
              use_regrets=True, use_benchmark_optimum=True,
              objective=Objective("loss", False))
    out, all_runs, all_groups = {}, [], {}
    for bench, stems in cells.items():
        runs, groups = [], {}
        for stem, title in stems:
            path = os.path.join(docs, stem + ".npy")
            if not os.path.exists(path):
                print(f"skip (missing): {path}")
                continue
            run, config = regrets_to_runs(np.load(path), stem)
            runs.append(run)
            groups[title] = [config]
        if not runs:
            continue
        out[f"{bench}_tpu_128studies_{stats}"] = grouped_results(
            runs, groups=groups, **kw)
        all_runs.extend(runs)
        all_groups.update(groups)
    if all_runs:
        out[f"figure_synthetic_tpu_{stats}"] = grouped_results(
            all_runs, groups=all_groups, n_cols=2, **kw)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", default="docs")
    ap.add_argument("--out-dir", default=os.path.join("build", "figures"))
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for robust in (True, False):
        for name, fig in figures(CELLS, args.docs, robust).items():
            out = os.path.join(args.out_dir, name + ".pdf")
            fig.savefig(out, bbox_inches="tight")
            print("figure ->", out)
            written.append(out)
    return written


if __name__ == "__main__":
    main()
