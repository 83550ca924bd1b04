"""Branin points-per-task ablation (reference
``benchmarking/configurations/branin_ablation_num_points_per_task.py:17-18,50-64``):
M = 8, N_m in {8,16,32,64,128,256}; 40 evals x 128 studies, sigma = 1.0."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.branin import Branin
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

NUM_META_TASKS = 8
NUM_POINTS_PER_TASK = [8, 16, 32, 64, 128, 256]

_DEFAULTS: Dict[str, Any] = dict(
    n_evaluations=40, n_studies=128, compute="PARALLEL")

OPTIMIZERS = {"SCAMLGP": ScaMLGPBO}

EXPERIMENTS = {}
for num_points in NUM_POINTS_PER_TASK:
    benchmark_config = {
        "cls": Branin,
        "kwargs": {"n_data_per_task": [num_points] * NUM_META_TASKS},
        "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 1.0}),
    }
    for optimizer_name, optimizer in OPTIMIZERS.items():
        EXPERIMENTS[
            f"Branin_T{NUM_META_TASKS}_P{num_points}_N1_{optimizer_name}"
        ] = Experiment(benchmark=benchmark_config, optimizer=optimizer,
                       **_DEFAULTS)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        f"Branin\n$M={NUM_META_TASKS} \\quad N_m={num_points}$":
            f"Branin_T{NUM_META_TASKS}_P{num_points}_N1"
        for num_points in NUM_POINTS_PER_TASK
    },
    objective=Objective("loss", greater_is_better=False),
    sharey="row",
)

if __name__ == "__main__":
    main(EXPERIMENTS)
