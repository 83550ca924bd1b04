"""NN tabular HPO experiment grid (reference
``benchmarking/configurations/nn_tabular.py:44-135``): HPOBench nn,
7 tasks x 128 pts; 60 evals x 256 studies; also prints a markdown regret
table at selected iterations."""

import json
from typing import List

import numpy as np
from scipy.stats import sem

from scamlgp_tpu_torch.benchmarking.configurations._shared import (
    hpobench_experiments,
    regret_cli,
)
from scamlgp_tpu_torch.benchmarking.configurations.styles import OPTIMIZER_STYLES
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.plotting import _regret_curves
from scamlgp_tpu_torch.bo.core import Objective


def _regret_stats(studies: list):
    regrets = np.asarray(_regret_curves(studies))
    return np.mean(regrets, axis=0), sem(regrets, axis=0)


def _print_markdown_table(results: dict, configs: List[Experiment],
                          iterations: List[int]):
    """Mean +- SEM regret at the given iterations, sorted by final regret
    (reference ``nn_tabular.py:44-97``)."""
    runs_data = list(results.values())
    ii = [i - 1 for i in iterations]
    run_configs = [Experiment(**run["experiment_config"])
                   for run in runs_data]

    print("| optimizer | " + " | ".join(str(i) for i in iterations), "|")
    print("|", " | ".join(["---"] * (len(iterations) + 1)), "|")

    stats = []
    for config in configs:
        try:
            i_config = run_configs.index(config)
        except ValueError:
            print("Unable to find configuration in available results, "
                  "skipping", json.dumps(config.__dict__, indent=2,
                                         default=str))
            continue
        data = runs_data[i_config]
        style = (OPTIMIZER_STYLES[config.optimizer["cls"]]
                 if isinstance(config.optimizer, dict)
                 else OPTIMIZER_STYLES[config.optimizer])
        regrets_mean, regrets_sem = _regret_stats(data["studies"])
        stats.append((style["label"], regrets_mean, regrets_sem))

    stats = sorted(stats, key=lambda x: x[1][-1])
    for label, regrets_mean, regrets_sem in stats:
        print("|", label, "|",
              "|".join(f"{m:0.2E} +/- {e:0.2E}"
                       for m, e in zip(regrets_mean[ii], regrets_sem[ii])),
              "|")


EXPERIMENTS = hpobench_experiments("nn", n_tasks=7, n_points=128)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={"NN Tabular\n7 Tasks à 128 Points": "NN_T7_P128"},
    objective=Objective("1 - Accuracy", False),
    robust_variants=(False,), label_stats=False,
    after_plot=lambda results: _print_markdown_table(
        results, configs=EXPERIMENTS.values(),
        iterations=[10, 20, 30, 40, 50, 60]),
)

if __name__ == "__main__":
    main(EXPERIMENTS)
