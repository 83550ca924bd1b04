"""HPOBench ML tabular benchmark wrapper
(``scamlgp_tpu/benchmarking/benchmarks/hpo_bench_tabular.py``, the
reference's ``hpo_bench_tabular.py:139-343``).

Wraps HPOBench's ``TabularBenchmark`` (lr/nn/rf/svm/xgb scenarios over OpenML
task IDs): random target-task selection, meta-tasks drawn without
replacement, objective "1 - Accuracy", optimum from the lookup table averaged
over seeds.  The ``hpobench`` + ``ConfigSpace`` dependencies are optional —
importing this module is safe; instantiating the benchmark without them
raises a clear error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
from scipy.stats.qmc import Sobol

from scamlgp_tpu_torch.benchmarking.benchmarks.api import Benchmark, SeedType, Task
from scamlgp_tpu_torch.bo.core import Evaluation, EvaluationSpecification, Objective
from scamlgp_tpu_torch.bo.space import (
    CategoricalParameter,
    ContinuousParameter,
    IntegerParameter,
    OrdinalParameter,
    ParameterSpace,
)

#: OpenML task IDs per scenario (reference ``hpo_bench_tabular.py:20-136``).
TASK_IDS = {
    "xgb": ["10101", "12", "146212", "146606", "146818", "146821", "146822",
            "14965", "167119", "167120", "168911", "168912", "3", "31",
            "3917", "53", "7592", "9952", "9977", "9981"],
    "rf": ["10101", "12", "146195", "146212", "146606", "146818", "146821",
           "146822", "14965", "167119", "167120", "168329", "168330",
           "168331", "168335", "168868", "168908", "168910", "168911",
           "168912", "3", "31", "3917", "53", "7592", "9952", "9977", "9981"],
    "lr": ["10101", "146195", "146606", "146821", "14965", "167120",
           "168330", "168335", "168908", "168910", "168912", "31", "53",
           "9952", "9981", "12", "146212", "146818", "146822", "167119",
           "168329", "168331", "168868", "168909", "168911", "3", "3917",
           "7592", "9977"],
    "svm": ["10101", "146195", "146606", "146821", "14965", "167120",
            "168330", "168335", "168908", "168910", "168912", "31", "53",
            "9952", "9981", "12", "146212", "146818", "146822", "167119",
            "168329", "168331", "168868", "168909", "168911", "3", "3917",
            "7592", "9977"],
    "nn": ["10101", "146818", "146821", "146822", "31", "3917", "53", "9952"],
}


def _import_hpobench():
    try:
        from hpobench.benchmarks.ml.tabular_benchmark import (
            TabularBenchmark,
        )
        return TabularBenchmark
    except ImportError as e:
        raise ImportError(
            "HPOBenchTabular requires the optional 'hpobench' package "
            "(and its tabular data). Install it from "
            "github.com/automl/HPOBench and pass data_dir to the downloaded "
            "tables.") from e


def space_from_configspace(cs) -> ParameterSpace:
    """Bridge a ConfigSpace configuration space into a native
    ``ParameterSpace`` (equivalent of parameterspace's
    ``parameterspace_from_configspace_dict`` used at reference ``:209-220``).
    Supports uniform float/int (with log), categorical, ordinal, constant.
    """
    import ConfigSpace as CS

    space = ParameterSpace()
    for hp in list(cs.values()) if hasattr(cs, "values") else \
            cs.get_hyperparameters():
        if isinstance(hp, CS.UniformFloatHyperparameter):
            space.add(ContinuousParameter(
                hp.name, (hp.lower, hp.upper),
                transformation="log" if hp.log else None))
        elif isinstance(hp, CS.UniformIntegerHyperparameter):
            space.add(IntegerParameter(hp.name, (hp.lower, hp.upper)))
        elif isinstance(hp, CS.OrdinalHyperparameter):
            space.add(OrdinalParameter(hp.name, list(hp.sequence)))
        elif isinstance(hp, CS.CategoricalHyperparameter):
            space.add(CategoricalParameter(hp.name, list(hp.choices)))
        elif isinstance(hp, CS.Constant):
            space.add(CategoricalParameter(hp.name, [hp.value]))
            space.fix(**{hp.name: hp.value})
        else:
            raise NotImplementedError(
                f"Unsupported hyperparameter type {type(hp)} for {hp.name}")
    return space


class HPOBenchTabular(Benchmark):
    def __init__(self, scenario: str,
                 n_data_per_task: Optional[List[int]] = None,
                 target_task_id: Optional[str] = None,
                 data_dir: Optional[str] = None,
                 seed: Optional[SeedType] = None):
        """See the reference docstring (``hpo_bench_tabular.py:148-164``):
        no multi-fidelity exposure; the target task is sampled randomly from
        the scenario's task IDs unless given."""
        if scenario not in TASK_IDS:
            raise ValueError(
                f"Scenario '{scenario}' needs to be one of {list(TASK_IDS)}")
        if n_data_per_task is None:
            n_data_per_task = []
        self._scenario = scenario
        self._data_dir = data_dir
        self.objectives = [Objective("1 - Accuracy", greater_is_better=False)]
        self._n_data_per_task = n_data_per_task
        self._prng = np.random.default_rng(seed)
        self._seed = seed

        task_ids = TASK_IDS[scenario].copy()
        if target_task_id is not None:
            if target_task_id not in task_ids:
                raise ValueError(
                    f"Target task ID '{target_task_id}' needs to be one of "
                    f"{task_ids}")
        else:
            target_task_id = self._prng.choice(task_ids)
        task_ids.remove(target_task_id)
        meta_task_ids = self._prng.choice(task_ids,
                                          size=len(n_data_per_task),
                                          replace=False)
        self._target_task = Task(uid=target_task_id,
                                 descriptors={"task_id": target_task_id},
                                 settings={}, context={})
        self._meta_tasks = {
            i: Task(uid=i, descriptors={"task_id": i}, settings={},
                    context={})
            for i in meta_task_ids
        }

        TabularBenchmark = _import_hpobench()
        self._target_task_benchmark = TabularBenchmark(
            model=scenario, task_id=self.target_task.uid,
            data_dir=data_dir, rng=seed)
        self._search_space = space_from_configspace(
            self._target_task_benchmark.get_configuration_space())
        # NOTE: no multi-fidelity support (reference :222-225)
        self._default_fidelities = dict(
            self._target_task_benchmark.get_fidelity_space()
            .get_default_configuration())

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
        """Minimum over per-config mean ``function_value`` across seeds at
        default fidelity (reference ``:243-267``)."""
        df = self._target_task_benchmark.table
        for key, value in self._default_fidelities.items():
            df = df[df[key].values == value]
        df = df.assign(function_value=[d["function_value"]
                                       for d in df["result"].values])
        names = [p.name for p in self._search_space._params]
        return (df.groupby(names, as_index=False)
                .mean(numeric_only=True)["function_value"].min())

    def __call__(self, eval_spec: EvaluationSpecification,
                 task_uid: Optional[Union[str, int]] = None) -> Evaluation:
        if task_uid is not None and task_uid not in TASK_IDS[self._scenario]:
            raise ValueError(
                f"Task ID '{task_uid}' needs to be one of "
                f"{TASK_IDS[self._scenario]}")
        if task_uid is None:
            task_uid = self.target_task.uid

        TabularBenchmark = _import_hpobench()
        benchmark = (self._target_task_benchmark
                     if task_uid == self.target_task.uid
                     else TabularBenchmark(
                         model=self._scenario, task_id=task_uid,
                         data_dir=self._data_dir,
                         rng=self._prng.bit_generator.random_raw()))
        result = benchmark(configuration=eval_spec.configuration,
                           fidelity=self._default_fidelities)
        return eval_spec.create_evaluation(
            {self.objectives[0].name: result})

    def get_meta_data(self, seed: Optional[SeedType] = None,
                      distribution: str = "random"
                      ) -> Dict[Union[str, int], List[Evaluation]]:
        """Random/sobol samples of the real lookup table per meta task
        (reference ``:298-343``)."""
        if distribution not in ("random", "sobol"):
            raise ValueError(
                f"Distribution for meta data generation {distribution} needs "
                "to be one of 'random' or 'sobol'.")
        prng = np.random.default_rng(seed)
        sobol = Sobol(d=len(self.search_space), scramble=True, seed=seed)
        TabularBenchmark = _import_hpobench()

        meta_data: Dict[Union[str, int], List[Evaluation]] = {}
        for (uid, _), n_data in zip(self.meta_tasks.items(),
                                    self._n_data_per_task):
            meta_data[uid] = []
            benchmark = TabularBenchmark(model=self._scenario, task_id=uid,
                                         data_dir=self._data_dir, rng=seed)
            for _ in range(n_data):
                if distribution == "random":
                    config = self.search_space.sample(rng=prng)
                else:
                    config = self.search_space.from_numerical(
                        sobol.random().flatten())
                result = benchmark(configuration=config)
                meta_data[uid].append(Evaluation(
                    configuration=config,
                    objectives={self.objectives[0].name: result}))
            del benchmark
        return meta_data
