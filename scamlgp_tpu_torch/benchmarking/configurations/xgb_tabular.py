"""XGB tabular HPO experiment grid (reference
``benchmarking/configurations/xgb_tabular.py:44``):
HPOBench xgb, 19 tasks x 128 pts; 60 evals x 256 studies."""

from scamlgp_tpu_torch.benchmarking.configurations._shared import (
    hpobench_experiments,
    regret_cli,
)
from scamlgp_tpu_torch.bo.core import Objective

EXPERIMENTS = hpobench_experiments("xgb", n_tasks=19, n_points=128)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={"XGB Tabular\n19 Tasks à 128 Points": "XGB_T19_P128"},
    objective=Objective("1 - Accuracy", False),
    robust_variants=(False,), label_stats=False,
)

if __name__ == "__main__":
    main(EXPERIMENTS)
