"""Hartmann3D experiment grid (reference
``benchmarking/configurations/hartmann3.py:43-76``): sigma = 0.1,
40 evals x 128 studies, M = 8 / 32 x 32 points."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_3d import Hartmann3D
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

DEFAULTS_HARTMANN_3D: Dict[str, Any] = dict(
    n_evaluations=40, n_studies=128, compute="PARALLEL")

HM3_CONFIG = {
    "cls": Hartmann3D,
    "kwargs": {"n_data_per_task": []},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}
HM3_T8_P32_CONFIG = {
    "cls": Hartmann3D,
    "kwargs": {"n_data_per_task": [32] * 8},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}
HM3_T32_P32_CONFIG = {
    "cls": Hartmann3D,
    "kwargs": {"n_data_per_task": [32] * 32},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}
HM3_T32_P256_CONFIG = {
    "cls": Hartmann3D,
    "kwargs": {"n_data_per_task": [256] * 32},
    "noise_spec": HomoscedasticGaussianNoise(noise_std={"loss": 0.1}),
}

EXPERIMENTS = {
    "HM3_T8_P32_N01_SCAMLGP": Experiment(
        benchmark=HM3_T8_P32_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_HARTMANN_3D),
    "HM3_T32_P32_N01_SCAMLGP": Experiment(
        benchmark=HM3_T32_P32_CONFIG, optimizer=ScaMLGPBO,
        **DEFAULTS_HARTMANN_3D),
}

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        "Hartmann3D\n8 Tasks à 32 Points (σ_noise=0.1)": "HM3_T8_P32_N01",
        "Hartmann3D\n32 Tasks à 32 Points (σ_noise=0.1)": "HM3_T32_P32_N01",
    },
    objective=Objective("loss", greater_is_better=False),
)

if __name__ == "__main__":
    main(EXPERIMENTS)
