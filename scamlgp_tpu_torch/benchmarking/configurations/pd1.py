"""PD1 experiment grid (reference
``benchmarking/configurations/pd1.py:38-46``): 22 tasks x 128 pts;
60 evals x 256 studies."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.pd1 import PD1
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

_PD1_T22_P128_CONFIG = {"cls": PD1, "kwargs": {"n_data_per_task": [128] * 22}}

_DEFAULTS: Dict[str, Any] = dict(
    n_evaluations=60, n_studies=256, compute="PARALLEL")

EXPERIMENTS = {
    "PD1_T22_P128_SCAMLGP": Experiment(
        benchmark=_PD1_T22_P128_CONFIG, optimizer=ScaMLGPBO, **_DEFAULTS),
}

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={"PD1\n" + r"$M=22 \quad N_m=128$": "PD1_T22_P128"},
    objective=Objective("best_valid/error_rate", False),
    robust_variants=(False,), label_stats=False,
)

if __name__ == "__main__":
    main(EXPERIMENTS)
