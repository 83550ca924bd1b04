"""Combined synthetic-benchmark paper figure (reference
``benchmarking/configurations/figure_synthetic.py:29-95``)."""

from pathlib import Path

from scamlgp_tpu_torch.benchmarking.configurations.branin import (
    EXPERIMENTS as EXPERIMENTS_BRANIN,
)
from scamlgp_tpu_torch.benchmarking.configurations.hartmann3 import (
    EXPERIMENTS as EXPERIMENTS_HARTMANN_3D,
)
from scamlgp_tpu_torch.benchmarking.configurations.hartmann6 import (
    EXPERIMENTS as EXPERIMENTS_HARTMANN_6D,
)
from scamlgp_tpu_torch.benchmarking.configurations.styles import OPTIMIZER_STYLES
from scamlgp_tpu_torch.benchmarking.plotting import grouped_results
from scamlgp_tpu_torch.benchmarking.utils import with_experiment_cli_and_data_loading
from scamlgp_tpu_torch.bo.core import Objective


@with_experiment_cli_and_data_loading
def main(results: dict):
    for robust_statistics in [True, False]:
        fig = grouped_results(
            list(results.values()),
            optimizer_styles=OPTIMIZER_STYLES,
            groups={
                "Branin\n" + r"$M=8 \quad N_m=32$": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("BRANIN_T8_P32_N1")],
                "Hartmann 3D\n" + r"$M=8 \quad N_m=32$": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("HM3_T8_P32_N01")],
                "Hartmann 6D\n" + r"$M=8 \quad N_m=128$": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("HARTMANN_6D_T8_P128_N01")],
                r"$M=32 \quad N_m=32$": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("BRANIN_T32_P32_N1")],
                # trailing space keeps dict keys unique while rendering the
                # same label (reference figure_synthetic.py:52-55)
                r"$M=32 \quad N_m=32$ ": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("HM3_T32_P32_N01")],
                r"$M=32 \quad N_m=128$": [
                    v for k, v in EXPERIMENTS.items()
                    if k.startswith("HARTMANN_6D_T32_P128_N01")],
            },
            use_regrets=True,
            robust_statistics=robust_statistics,
            use_benchmark_optimum=True,
            objective=Objective("loss", greater_is_better=False),
            x_limits=[(1, 40), (1, 40), (1, 80), (1, 40), (1, 40), (1, 80)],
            y_limits=[(2e-2, 10.0), (5e-3, 1.0), (3e-2, 1.0),
                      (2e-2, 10.0), (5e-3, 1.0), (3e-2, 1.0)],
        )
        stats_label = "median_25quant75" if robust_statistics else "mean_sem"
        fig.savefig(
            Path(__file__).parent
            / f"{Path(__file__).name[:-3]}_benchmark_wise_regrets_"
              f"{stats_label}.pdf")


EXPERIMENTS = {
    **EXPERIMENTS_BRANIN,
    **EXPERIMENTS_HARTMANN_3D,
    **EXPERIMENTS_HARTMANN_6D,
}

if __name__ == "__main__":
    main(EXPERIMENTS)
