"""Hartmann6D num-meta-tasks ablation (reference
``benchmarking/configurations/hartmann6_ablation_num_meta_tasks.py:17-18,53-66``):
M in {2,4,8,16,32,64}, N_m = 128; 80 evals x 128 studies, sigma = 0.1."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_6d import Hartmann6D
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

NUM_META_TASKS = [2, 4, 8, 16, 32, 64]
NUM_POINTS_PER_TASK = 128

_DEFAULTS: Dict[str, Any] = dict(
    n_evaluations=80, n_studies=128, compute="PARALLEL")

OPTIMIZERS = {"SCAMLGP": ScaMLGPBO}

EXPERIMENTS = {}
for num_tasks in NUM_META_TASKS:
    benchmark_config = {
        "cls": Hartmann6D,
        "kwargs": {"n_data_per_task": [NUM_POINTS_PER_TASK] * num_tasks},
        "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
    }
    for optimizer_name, optimizer in OPTIMIZERS.items():
        EXPERIMENTS[
            f"HARTMANN_6D_T{num_tasks}_P{NUM_POINTS_PER_TASK}_N01_"
            f"{optimizer_name}"
        ] = Experiment(benchmark=benchmark_config, optimizer=optimizer,
                       **_DEFAULTS)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        f"Hartmann6D\n$M={num_tasks} \\quad N_m={NUM_POINTS_PER_TASK}$":
            f"HARTMANN_6D_T{num_tasks}_P{NUM_POINTS_PER_TASK}_N01"
        for num_tasks in NUM_META_TASKS
    },
    objective=Objective("loss", greater_is_better=False),
    sharey="row",
)

if __name__ == "__main__":
    main(EXPERIMENTS)
