"""SVM tabular HPO experiment grid (reference
``benchmarking/configurations/svm_tabular.py:42-53``):
HPOBench svm, 28 tasks x 64 pts; 60 evals x 256 studies."""

from scamlgp_tpu_torch.benchmarking.configurations._shared import (
    hpobench_experiments,
    regret_cli,
)
from scamlgp_tpu_torch.bo.core import Objective

EXPERIMENTS = hpobench_experiments("svm", n_tasks=28, n_points=64)

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={"SVM Tabular\n28 Tasks à 64 Points": "SVM_T28_P64"},
    objective=Objective("1 - Accuracy", False),
    robust_variants=(False,), label_stats=False,
)

if __name__ == "__main__":
    main(EXPERIMENTS)
