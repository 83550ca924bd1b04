"""Hartmann6D experiment grid (reference
``benchmarking/configurations/hartmann6.py:47-74``): sigma = 0.1,
80 evals x 128 studies, M = 8 / 32 x 128 points."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_6d import Hartmann6D
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

DEFAULTS_HARTMANN_6D: Dict[str, Any] = dict(
    n_evaluations=80, n_studies=128, compute="PARALLEL")

HM6_CONFIG = {
    "cls": Hartmann6D,
    "kwargs": {"n_data_per_task": []},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}
HM6_T8_P128_CONFIG = {
    "cls": Hartmann6D,
    "kwargs": {"n_data_per_task": [128] * 8},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}
HM6_T32_P128_CONFIG = {
    "cls": Hartmann6D,
    "kwargs": {"n_data_per_task": [128] * 32},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}

EXPERIMENTS = {
    "HARTMANN_6D_T8_P128_N01_SCAMLGP": Experiment(
        benchmark=HM6_T8_P128_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_HARTMANN_6D),
    "HARTMANN_6D_T32_P128_N01_SCAMLGP": Experiment(
        benchmark=HM6_T32_P128_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_HARTMANN_6D),
}

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        "Hartmann6D\n8 Tasks à 128 Points (σ_noise=0.1)":
            "HARTMANN_6D_T8_P128_N01",
        "Hartmann6D\n32 Tasks à 128 Points (σ_noise=0.1)":
            "HARTMANN_6D_T32_P128_N01",
    },
    objective=Objective("loss", greater_is_better=False),
)

if __name__ == "__main__":
    main(EXPERIMENTS)
