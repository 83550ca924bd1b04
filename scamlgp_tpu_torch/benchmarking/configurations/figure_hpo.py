"""Combined HPO paper figure (reference
``benchmarking/configurations/figure_hpo.py:30-113``)."""

from pathlib import Path

from scamlgp_tpu_torch.benchmarking.configurations.fcnet_tabular import (
    EXPERIMENTS as EXPERIMENTS_FCNET,
)
from scamlgp_tpu_torch.benchmarking.configurations.lr_tabular import (
    EXPERIMENTS as EXPERIMENTS_LR,
)
from scamlgp_tpu_torch.benchmarking.configurations.nn_tabular import (
    EXPERIMENTS as EXPERIMENTS_NN,
)
from scamlgp_tpu_torch.benchmarking.configurations.rf_tabular import (
    EXPERIMENTS as EXPERIMENTS_RF,
)
from scamlgp_tpu_torch.benchmarking.configurations.styles import OPTIMIZER_STYLES
from scamlgp_tpu_torch.benchmarking.configurations.svm_tabular import (
    EXPERIMENTS as EXPERIMENTS_SVM,
)
from scamlgp_tpu_torch.benchmarking.configurations.xgb_tabular import (
    EXPERIMENTS as EXPERIMENTS_XGB,
)
from scamlgp_tpu_torch.benchmarking.plotting import grouped_results
from scamlgp_tpu_torch.benchmarking.utils import with_experiment_cli_and_data_loading
from scamlgp_tpu_torch.bo.core import Objective


@with_experiment_cli_and_data_loading
def main(results: dict):
    fig = grouped_results(
        list(results.values()),
        optimizer_styles=OPTIMIZER_STYLES,
        groups={
            "SVM\n" + r"$M=28 \quad N_m=64$": [
                v for k, v in EXPERIMENTS.items()
                if k.startswith("SVM_T28_P64")],
            "MLP\n" + r"$M=7 \quad N_m=128$": [
                v for k, v in EXPERIMENTS.items()
                if k.startswith("NN_T7_P128")],
            "XGB\n" + r"$M=19 \quad N_m=128$": [
                v for k, v in EXPERIMENTS.items()
                if k.startswith("XGB_T19_P128")],
            "RF\n" + r"$M=27 \quad N_m=128$": [
                v for k, v in EXPERIMENTS.items()
                if k.startswith("RF_T27_P128")],
            "LR\n" + r"$M=28 \quad N_m=64$": [
                v for k, v in EXPERIMENTS.items()
                if k.startswith("LR_T28_P64")],
            "Slice\n" + r"$M=3 \quad N_m=256$": [
                v for k, v in EXPERIMENTS.items() if k.startswith("SLICE_")],
            "Protein\n" + r"$M=3 \quad N_m=256$": [
                v for k, v in EXPERIMENTS.items() if k.startswith("PROTEIN_")],
            "Naval\n" + r"$M=3 \quad N_m=256$": [
                v for k, v in EXPERIMENTS.items() if k.startswith("NAVAL_")],
            "Parkinson's\n" + r"$M=3 \quad N_m=256$": [
                v for k, v in EXPERIMENTS.items() if k.startswith("PARKIN_")],
        },
        robust_statistics=False,
        use_regrets=True,
        objective=([Objective("1 - Accuracy", False)] * 5
                   + [Objective("valid_loss", False)] * 4),
        n_rows=3,
        n_cols=3,
        h_pad=1.2,
        fig_height=5.0,
        x_limits=[(1, 60)] * 9,
        y_limits=[(1e-3, 1e-1), (2e-3, 5e-2), (4e-4, 1e-2), (1e-4, 5e-2),
                  (4e-4, 1e-2), (1e-4, 1e-2), (1e-3, 1e-1), (1e-5, 1e-2),
                  (2e-3, 1e-1)],
    )
    fig.savefig(
        Path(__file__).parent
        / f"{Path(__file__).name[:-3]}_benchmark_wise_regrets.pdf")


EXPERIMENTS = {
    **EXPERIMENTS_LR,
    **EXPERIMENTS_NN,
    **EXPERIMENTS_RF,
    **EXPERIMENTS_SVM,
    **EXPERIMENTS_XGB,
    **EXPERIMENTS_FCNET,
}

if __name__ == "__main__":
    main(EXPERIMENTS)
