"""PD1 (HyperBO) learning-rate-schedule tabular benchmark
(``scamlgp_tpu/benchmarking/benchmarks/pd1.py``, the reference's
``pd1.py:25-165``).

Wraps the PD1 pickle dataframe (the data blob is not committed; its
provenance is in ``scamlgp_tpu/benchmarking/benchmarks/pd1.md``).  pandas is
imported by the constructor only, and ``task_rows`` hands the table's rows
of a task on as numpy arrays, so no caller needs pandas.  4-D continuous
space; evaluation is a nearest-neighbor lookup by L1 distance in parameter
space; 22 meta-tasks (ImageNet-ResNet50 excluded).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import Benchmark, SeedType, Task
from scamlgp_tpu_torch.bo.core import Evaluation, EvaluationSpecification, Objective
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace

HERE = Path(__file__).parent

_PARAMETER_NAMES = {
    "hps.lr_hparams.decay_steps_factor": "decay_steps_factor",
    "hps.lr_hparams.initial_value": "initial_value",
    "hps.lr_hparams.power": "power",
    "hps.opt_hparams.momentum": "momentum",
}

_EXCLUDED_TASK = "imagenet_resnet50,imagenet,resnet,resnet50,1024"


class PD1(Benchmark):
    def __init__(self, n_data_per_task: Optional[List[int]] = None,
                 target_task_id: Optional[str] = None,
                 seed: Optional[SeedType] = None,
                 data_file: Optional[str] = None, **kwargs):
        """Args mirror the reference; ``data_file`` points to the PD1 pickle
        (defaults to ``pd1.pickle`` next to this module)."""
        import pandas as pd

        self._n_data_per_task = n_data_per_task or []
        path = Path(data_file) if data_file else HERE / "pd1.pickle"
        if not path.exists():
            raise FileNotFoundError(
                f"PD1 data blob not found at {path}. The dataset is not "
                "distributed with this repo (see the reference's "
                "benchmarks/pd1.md for provenance); pass data_file= to the "
                "downloaded pickle.")
        self._df: "pd.DataFrame" = pd.read_pickle(path)
        self._df = self._df.rename(columns=_PARAMETER_NAMES)

        self._search_space = ParameterSpace()
        self._search_space.add(
            ContinuousParameter("decay_steps_factor", (0.01, 0.99)))
        self._search_space.add(
            ContinuousParameter("initial_value", (np.log(1e-5), np.log(10))))
        self._search_space.add(ContinuousParameter("power", (0.1, 2.0)))
        self._search_space.add(
            ContinuousParameter("momentum", (np.log(1e-3), np.log(1))))

        self._objective = Objective("best_valid/error_rate",
                                    greater_is_better=False)
        self._prng = np.random.default_rng(seed)

        task_ids = list(self._df["study_group"].unique())
        task_ids.remove(_EXCLUDED_TASK)
        if target_task_id is not None:
            if target_task_id not in task_ids:
                raise ValueError(
                    f"Target task ID '{target_task_id}' needs to be one of "
                    f"{task_ids}")
        else:
            target_task_id = self._prng.choice(task_ids)
        task_ids.remove(target_task_id)
        meta_task_ids = self._prng.choice(
            task_ids, size=len(self._n_data_per_task), replace=False)
        self._target_task = Task(uid=target_task_id,
                                 descriptors={"task_id": target_task_id},
                                 settings={}, context={})
        self._meta_tasks = {
            task_id: Task(uid=task_id, descriptors={"task_id": task_id},
                          settings={}, context={})
            for task_id in meta_task_ids
        }

    def task_rows(self, task_uid: Optional[Union[str, int]] = None):
        """The table's rows of a task (the target task by default) as numpy
        ``(coords (R, d), values (R,))``: the free parameters' columns in
        the search space's order, and the objective."""
        if task_uid is None:
            task_uid = self.target_task.uid
        task_df = self._df[self._df["study_group"] == task_uid]
        names = self.search_space.get_parameter_names()
        return (task_df[names].values.astype(np.float64),
                task_df[self._objective.name].values.astype(np.float64))

    def __call__(self, eval_spec: EvaluationSpecification,
                 task_uid: Optional[Union[str, int]] = None) -> Evaluation:
        """Nearest-neighbor lookup by L1 distance in parameter space
        (reference ``pd1.py:103-111``)."""
        if task_uid is None:
            task_uid = self.target_task.uid
        task_df = self._df[self._df["study_group"] == task_uid]
        parameter_values = task_df[eval_spec.configuration.keys()].values
        absolute_differences = np.abs(
            parameter_values
            - np.array(list(eval_spec.configuration.values())))
        i_closest = np.argmin(absolute_differences.sum(1))
        objective_value = task_df.iloc[i_closest][self._objective.name]
        return eval_spec.create_evaluation(
            objectives={self._objective.name: objective_value})

    @property
    def objective(self) -> Objective:
        return self._objective

    @property
    def objectives(self) -> List[Objective]:
        return [self._objective]

    @property
    def target_task(self):
        return self._target_task

    @property
    def meta_tasks(self):
        return self._meta_tasks

    @property
    def search_space(self) -> ParameterSpace:
        return self._search_space

    @property
    def output_dimensions(self) -> int:
        return len(self.objectives)

    @property
    def optimum(self) -> float:
        """Table minimum for the target task (reference ``pd1.py:141-145``)."""
        task_df = self._df[self._df["study_group"] == self.target_task.uid]
        return task_df[self._objective.name].min()

    def get_meta_data(self, distribution="random", seed=None):
        if distribution != "random":
            raise NotImplementedError(
                f"Only random distribution is available, but got "
                f"{distribution}.")
        meta_data = {}
        for task_id, n_task_data in zip(self.meta_tasks.keys(),
                                        self._n_data_per_task):
            task_df = self._df[self._df["study_group"] == task_id]
            meta_data[task_id] = [
                Evaluation(
                    configuration=row[
                        self.search_space.get_parameter_names()].to_dict(),
                    objectives={self._objective.name:
                                float(row[self._objective.name])})
                for _, row in task_df.sample(
                    n=n_task_data, replace=False).iterrows()]
        return meta_data
