"""FCNet fixed-fidelity tabular benchmark
(``scamlgp_tpu/benchmarking/benchmarks/fcnet_fixed_fidelity_tabular.py``, the
reference's ``fcnet_fixed_fidelity_tabular.py:126-253``).

HDF5 lookup-table benchmark over 4 regression datasets; lazy LUT loading
keyed by a canonical JSON config string; hard-coded search space and known
optima; ``fix_search_space`` pins categoricals.
"""

from __future__ import annotations

import tarfile
import tempfile
import urllib.request
from os import PathLike
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.bo.core import Evaluation, EvaluationSpecification, Objective
from scamlgp_tpu_torch.bo.space import (
    CategoricalParameter,
    OrdinalParameter,
    ParameterSpace,
)

_DATASET_URL = ("https://ml4aad.org/wp-content/uploads/2019/01/"
                "fcnet_tabular_benchmarks.tar.gz")

#: Known per-dataset optima at mean valid_loss across seeds
#: (reference ``fcnet_fixed_fidelity_tabular.py:25-82``).
_OPTIMAL_CONFIGS_WITH_MEAN_VALID_LOSS = {
    "fcnet_slice_localization_data": Evaluation(
        configuration={"activation_fn_1": "relu", "activation_fn_2": "tanh",
                       "batch_size": 16, "dropout_1": 0.0, "dropout_2": 0.0,
                       "init_lr": 0.0005, "lr_schedule": "cosine",
                       "n_units_1": 256, "n_units_2": 512},
        objectives={"valid_loss": 0.00019159916337230243}),
    "fcnet_protein_structure_data": Evaluation(
        configuration={"activation_fn_1": "relu", "activation_fn_2": "relu",
                       "batch_size": 8, "dropout_1": 0.0, "dropout_2": 0.3,
                       "init_lr": 0.0005, "lr_schedule": "cosine",
                       "n_units_1": 512, "n_units_2": 512},
        objectives={"valid_loss": 0.221378855407238}),
    "fcnet_naval_propulsion_data": Evaluation(
        configuration={"activation_fn_1": "tanh", "activation_fn_2": "relu",
                       "batch_size": 8, "dropout_1": 0.0, "dropout_2": 0.0,
                       "init_lr": 0.0005, "lr_schedule": "cosine",
                       "n_units_1": 128, "n_units_2": 512},
        objectives={"valid_loss": 3.19113473778998e-05}),
    "fcnet_parkinsons_telemonitoring_data": Evaluation(
        configuration={"activation_fn_1": "relu", "activation_fn_2": "relu",
                       "batch_size": 8, "dropout_1": 0.0, "dropout_2": 0.0,
                       "init_lr": 0.005, "lr_schedule": "cosine",
                       "n_units_1": 32, "n_units_2": 512},
        objectives={"valid_loss": 0.0067059280117973685}),
}


def _make_search_space(seed=None) -> ParameterSpace:
    """The FCNet space (reference's hard-coded parameterspace JSON,
    ``fcnet_fixed_fidelity_tabular.py:23``)."""
    s = ParameterSpace()
    s.add(CategoricalParameter("activation_fn_1", ["tanh", "relu"]))
    s.add(CategoricalParameter("activation_fn_2", ["tanh", "relu"]))
    s.add(OrdinalParameter("batch_size", [8, 16, 32, 64]))
    s.add(OrdinalParameter("dropout_1", [0.0, 0.3, 0.6]))
    s.add(OrdinalParameter("dropout_2", [0.0, 0.3, 0.6]))
    s.add(OrdinalParameter("init_lr",
                           [0.0005, 0.001, 0.005, 0.01, 0.05, 0.1]))
    s.add(CategoricalParameter("lr_schedule", ["cosine", "const"]))
    s.add(OrdinalParameter("n_units_1", [16, 32, 64, 128, 256, 512]))
    s.add(OrdinalParameter("n_units_2", [16, 32, 64, 128, 256, 512]))
    if seed is not None:
        s.seed(seed)
    return s


def _download_and_extract_look_up_tables(
        target_directory: Optional[PathLike] = None) -> Path:
    tmp_download_target = Path(tempfile.gettempdir(),
                               "fcnet_tabular_benchmarks.tar.gz")
    if not tmp_download_target.exists():
        urllib.request.urlretrieve(_DATASET_URL, str(tmp_download_target))
    if target_directory is None:
        target_directory = Path(tempfile.mkdtemp(prefix="bbo_bench_fcnet_"))
    with tarfile.open(tmp_download_target) as fh:
        fh.extractall(target_directory)
    return Path(target_directory) / "fcnet_tabular_benchmarks"


def _load_look_up_table(hdf5_lut_file: PathLike,
                        metric_name: str = "valid_loss", i_epoch: int = -1,
                        i_seed: Optional[int] = None) -> Dict[str, float]:
    """Mean (or per-seed) metric at the chosen epoch per canonical config key
    (reference ``:102-123``)."""
    import h5py

    lut = {}
    with h5py.File(hdf5_lut_file) as fh:
        for k, v in fh.items():
            if i_seed is None:
                lut[k] = float(np.mean(v[metric_name][()][:, i_epoch]))
            else:
                lut[k] = float(v[metric_name][()][i_seed, i_epoch])
    return lut


class FCNetFixedFidelityTabularBenchmark:
    def __init__(self, target_task_file: str,
                 meta_task_files: Optional[List[str]] = None,
                 n_data_per_task: Optional[List[int]] = None,
                 fix_search_space: Optional[Dict[str, Any]] = None,
                 lazy_load_target_task_lut: bool = True,
                 seed: Optional[SeedType] = None) -> None:
        """Light wrapper of the FCNet tabular dataset; see the reference
        docstring (``:136-150``)."""
        meta_task_files = meta_task_files or []
        n_data_per_task = n_data_per_task or []
        assert len(meta_task_files) == len(n_data_per_task), \
            "Meta tasks need to match data per task specification"

        self._objective = Objective("valid_loss", greater_is_better=False)
        self._meta_task_files = meta_task_files
        self._n_data_per_task = n_data_per_task
        self._fix_search_space = fix_search_space or {}
        self._search_space = _make_search_space(seed)
        self._search_space.fix(**self._fix_search_space)

        self._target_task_file = target_task_file
        if not Path(self._target_task_file).exists():
            print("Downloading tabular dataset, because no file found at",
                  self._target_task_file)
            download_directory = _download_and_extract_look_up_tables()
            self._target_task_file = download_directory / target_task_file
            self._meta_task_files = [str(download_directory / mtf)
                                     for mtf in meta_task_files]

        self._target_task_lut = (
            None if lazy_load_target_task_lut
            else _load_look_up_table(self._target_task_file,
                                     metric_name=self._objective.name))

    @property
    def objective(self) -> Objective:
        return self._objective

    @property
    def objectives(self) -> List[Objective]:
        return [self._objective]

    @property
    def optimum(self) -> float:
        return _OPTIMAL_CONFIGS_WITH_MEAN_VALID_LOSS[
            Path(self._target_task_file).stem].objectives[
                self._objective.name]

    @property
    def output_dimensions(self) -> int:
        return 1

    @property
    def search_space(self) -> ParameterSpace:
        return self._search_space

    @staticmethod
    def _lut_key(configuration: Dict[str, Any]) -> str:
        """Canonical JSON-ish key: python dict repr with sorted keys and
        double quotes (reference ``:226-230``)."""
        config = {k: configuration[k] for k in sorted(configuration.keys())}
        return str(config).replace("'", '"')

    def __call__(self, eval_spec: EvaluationSpecification,
                 task_uid: Optional[Union[str, int]] = None) -> Evaluation:
        if task_uid is not None:
            raise NotImplementedError("No support for custom target task IDs.")
        if self._target_task_lut is None:
            self._target_task_lut = _load_look_up_table(
                self._target_task_file, metric_name=self._objective.name)
        objective_value = self._target_task_lut[
            self._lut_key(eval_spec.configuration)]
        return eval_spec.create_evaluation(
            objectives={self._objective.name: objective_value})

    def get_meta_data(self, distribution: str = "random",
                      seed: Optional[SeedType] = None
                      ) -> Dict[Union[str, int], List[Evaluation]]:
        if distribution != "random":
            raise NotImplementedError(
                f"Distribution {distribution} is unavailable.")
        meta_data = {}
        for i_task, meta_task_file in enumerate(self._meta_task_files):
            bm = FCNetFixedFidelityTabularBenchmark(
                target_task_file=meta_task_file,
                fix_search_space=self._fix_search_space, seed=seed)
            meta_data[Path(meta_task_file).stem] = [
                bm(EvaluationSpecification(bm.search_space.sample()))
                for _ in range(self._n_data_per_task[i_task])]
        return meta_data
