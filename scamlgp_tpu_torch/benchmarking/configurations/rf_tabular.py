"""RF tabular HPO experiment grid (reference
``benchmarking/configurations/rf_tabular.py:44``):
HPOBench rf, 27 tasks x 128 pts; 60 evals x 256 studies."""

from scamlgp_tpu_torch.benchmarking.configurations._shared import (
    hpobench_experiments,
    regret_cli,
)
from scamlgp_tpu_torch.bo.core import Objective

EXPERIMENTS = hpobench_experiments("rf", n_tasks=27, n_points=128)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={"RF Tabular\n27 Tasks à 128 Points": "RF_T27_P128"},
    objective=Objective("1 - Accuracy", False),
    robust_variants=(False,), label_stats=False,
)

if __name__ == "__main__":
    main(EXPERIMENTS)
