"""Branin experiment grid (reference
``benchmarking/configurations/branin.py:47-75``): sigma_noise = 1.0,
40 evals x 128 studies, M = 8 / 32 tasks x 32 points.

CLI: ``python -m scamlgp_tpu_torch.benchmarking.configurations.branin
submit|visualize|hash all``.
"""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.branin import Branin
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

DEFAULTS_BRANIN: Dict[str, Any] = dict(
    n_evaluations=40, n_studies=128, compute="PARALLEL")

BRANIN_CONFIG = {
    "cls": Branin,
    "kwargs": {"n_data_per_task": []},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 1.0}),
}
BRANIN_T8_P32_CONFIG = {
    "cls": Branin,
    "kwargs": {"n_data_per_task": [32] * 8},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 1.0}),
}
BRANIN_T32_P32_CONFIG = {
    "cls": Branin,
    "kwargs": {"n_data_per_task": [32] * 32},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 1.0}),
}

EXPERIMENTS = {
    "BRANIN_T8_P32_N1_SCAMLGP": Experiment(
        benchmark=BRANIN_T8_P32_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_BRANIN),
    "BRANIN_T32_P32_N1_SCAMLGP": Experiment(
        benchmark=BRANIN_T32_P32_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_BRANIN),
}

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        "Branin\n8 Tasks à 32 Points (σ_noise=1.0)": "BRANIN_T8_P32_N1",
        "Branin\n32 Tasks à 32 Points (σ_noise=1.0)": "BRANIN_T32_P32_N1",
    },
    objective=Objective("loss", greater_is_better=False),
)

if __name__ == "__main__":
    main(EXPERIMENTS)
