"""FCNet tabular experiment grid (reference
``benchmarking/configurations/fcnet_tabular.py:60-136``): each of 4 datasets
as target vs the other 3 as meta (3 x 256 pts), categoricals fixed to
near-optimal values; 80 evals x 128 studies."""

from typing import Any, Dict

from scamlgp_tpu_torch.benchmarking.benchmarks.fcnet_fixed_fidelity_tabular import (
    FCNetFixedFidelityTabularBenchmark,
)
from scamlgp_tpu_torch.benchmarking.configurations._shared import regret_cli
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

_T3_P256_KWARGS = {
    "n_data_per_task": [256] * 3,
    # don't expose the categoricals for optimization; pin them to the
    # (close-to) optimal values (reference fcnet_tabular.py:60-69)
    "fix_search_space": {
        "activation_fn_1": "relu",
        "activation_fn_2": "relu",
        "lr_schedule": "cosine",
    },
}

_ALL_FILES = [
    "fcnet_naval_propulsion_data.hdf5",
    "fcnet_parkinsons_telemonitoring_data.hdf5",
    "fcnet_protein_structure_data.hdf5",
    "fcnet_slice_localization_data.hdf5",
]


def _config(target_file: str) -> Dict[str, Any]:
    return {
        "cls": FCNetFixedFidelityTabularBenchmark,
        "kwargs": {
            "target_task_file": target_file,
            "meta_task_files": [f for f in _ALL_FILES if f != target_file],
            **_T3_P256_KWARGS,
        },
    }


_SLICE_T3_P256_CONFIG = _config("fcnet_slice_localization_data.hdf5")
_NAVAL_T3_P256_CONFIG = _config("fcnet_naval_propulsion_data.hdf5")
_PARKIN_T3_P256_CONFIG = _config("fcnet_parkinsons_telemonitoring_data.hdf5")
_PROTEIN_T3_P256_CONFIG = _config("fcnet_protein_structure_data.hdf5")

_DEFAULTS: Dict[str, Any] = dict(
    n_evaluations=80, n_studies=128, compute="PARALLEL")

EXPERIMENTS = {
    "SLICE_T3_P256_SCAMLGP": Experiment(
        benchmark=_SLICE_T3_P256_CONFIG, optimizer=ScaMLGPBO, **_DEFAULTS),
    "PROTEIN_T3_P256_SCAMLGP": Experiment(
        benchmark=_PROTEIN_T3_P256_CONFIG, optimizer=ScaMLGPBO, **_DEFAULTS),
    "PARKIN_T3_P256_SCAMLGP": Experiment(
        benchmark=_PARKIN_T3_P256_CONFIG, optimizer=ScaMLGPBO, **_DEFAULTS),
    "NAVAL_T3_P256_SCAMLGP": Experiment(
        benchmark=_NAVAL_T3_P256_CONFIG, optimizer=ScaMLGPBO, **_DEFAULTS),
}

main = regret_cli(
    __file__, EXPERIMENTS,
    groups={
        "FCNet Slice\n3 Tasks à 256 Points": "SLICE_T3_P256",
        "FCNet Protein\n3 Tasks à 256 Points": "PROTEIN_T3_P256",
        "FCNet Parkinsons\n3 Tasks à 256 Points": "PARKIN_T3_P256",
        "FCNet Naval\n3 Tasks à 256 Points": "NAVAL_T3_P256",
    },
    objective=Objective("valid_loss", False),
    robust_variants=(False,), label_stats=False,
)

if __name__ == "__main__":
    main(EXPERIMENTS)
