"""Hartmann6D points-per-task ablation (reference
``benchmarking/configurations/hartmann6_ablation_num_points_per_task.py:17-18,53-66``):
M = 8, N_m in {16,32,64,128,256,512}; 80 evals x 128 studies, sigma = 0.1."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_6d import Hartmann6D
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

NUM_META_TASKS = 8
NUM_POINTS_PER_TASK = [16, 32, 64, 128, 256, 512]

_DEFAULTS: Dict[str, Any] = dict(
    n_evaluations=80, n_studies=128, compute="PARALLEL")

OPTIMIZERS = {"SCAMLGP": ScaMLGPBO}

EXPERIMENTS = {}
for num_points in NUM_POINTS_PER_TASK:
    benchmark_config = {
        "cls": Hartmann6D,
        "kwargs": {"n_data_per_task": [num_points] * NUM_META_TASKS},
        "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
    }
    for optimizer_name, optimizer in OPTIMIZERS.items():
        EXPERIMENTS[
            f"HARTMANN_6D_T{NUM_META_TASKS}_P{num_points}_N01_"
            f"{optimizer_name}"
        ] = Experiment(benchmark=benchmark_config, optimizer=optimizer,
                       **_DEFAULTS)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        f"Hartmann6D\n$M={NUM_META_TASKS} \\quad N_m={num_points}$":
            f"HARTMANN_6D_T{NUM_META_TASKS}_P{num_points}_N01"
        for num_points in NUM_POINTS_PER_TASK
    },
    objective=Objective("loss", greater_is_better=False),
    sharey="row",
)

if __name__ == "__main__":
    main(EXPERIMENTS)
