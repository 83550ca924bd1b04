"""Parametric-function benchmark base (reference
``reference benchmarking/benchmarks/base.py:51-268``):
random task creation from descriptor/settings/context spaces, evaluation by
merging config + task parameters, random/sobol meta-data generation, and
ground-truth optimum via scipy SHGO (host-side — offline ground truth stays on
CPU per SURVEY.md section 2.4)."""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import scipy.optimize as opt
from scipy.optimize import OptimizeResult
from scipy.stats.qmc import Sobol

from scamlgp_tpu_torch.benchmarking.benchmarks.api import Benchmark, SeedType, Task
from scamlgp_tpu_torch.bo.core import Evaluation, EvaluationSpecification, Objective
from scamlgp_tpu_torch.bo.space import ParameterSpace


def _shgo_minimize(eval_func: Callable, search_space: ParameterSpace
                   ) -> OptimizeResult:
    """Simplicial homology global optimization with sobol sampling, n=1024
    (reference ``base.py:17-48``; paper https://doi.org/10.1007/s10898-018-0645-y).

    The search is over the unit cube composed with ``from_numerical`` — same
    true optimum as the reference's original-bounds search (its
    ``from_numerical`` clipping makes the composed landscape cover the full
    domain inside [0,1]^d either way), without relying on that quirk.
    """
    bounds = [(0.0, 1.0)] * len(search_space)
    return opt.shgo(eval_func, bounds=bounds, sampling_method="sobol", n=1024)


class Base(Benchmark):
    def __init__(self, descriptors: ParameterSpace, settings: ParameterSpace,
                 context: ParameterSpace, search_space: ParameterSpace,
                 target_task: Task,
                 meta_tasks: Dict[Union[str, int], Task],
                 n_data_per_task: List[int],
                 objectives: Optional[List[Objective]] = None):
        """See the reference docstring (``base.py:63-97``): descriptors are
        hidden task parameters, settings are user-chosen, context is observed
        but not chosen; ``n_data_per_task`` gives per-meta-task observation
        counts (heterogeneous sizes supported)."""
        self._descriptors = descriptors
        self._settings = settings
        self._context = context
        self._search_space = search_space
        self._target_task = target_task
        self._meta_tasks = meta_tasks
        self._n_data_per_task = n_data_per_task
        self._objectives = ([Objective("loss", greater_is_better=False)]
                            if objectives is None else objectives)

    @property
    def target_task(self) -> Task:
        return self._target_task

    @property
    def meta_tasks(self) -> Dict[Union[str, int], Task]:
        return self._meta_tasks

    @property
    def search_space(self) -> ParameterSpace:
        return self._search_space

    @property
    def output_dimensions(self) -> int:
        return len(self.objectives)

    @property
    def objectives(self) -> List[Objective]:
        return self._objectives

    @staticmethod
    def create_tasks(descriptors, settings, context, num_meta_tasks,
                     seed: Optional[SeedType] = None):
        """Target task uid 0 with default (seedless) parameters; meta tasks
        uid 1..M sampled from the shared prng (reference ``base.py:119-133``)."""
        prng = np.random.default_rng(seed)
        target_task = Base.create_random_task(0, descriptors, settings, context)
        meta_tasks = {
            uid: Base.create_random_task(uid, descriptors, settings, context,
                                         prng)
            for uid in range(1, num_meta_tasks + 1)
        }
        return target_task, meta_tasks

    @staticmethod
    def create_random_task(uid, descriptors: ParameterSpace,
                           settings: ParameterSpace, context: ParameterSpace,
                           seed: Optional[SeedType] = None) -> Task:
        prng = np.random.default_rng(seed)
        return Task(uid, descriptors.sample(rng=prng),
                    settings.sample(rng=prng), context.sample(rng=prng))

    def __call__(self, eval_spec: EvaluationSpecification,
                 task_uid: Optional[Union[str, int]] = None) -> Evaluation:
        """Evaluate at a configuration, filling in the task's settings and
        context defaults (reference ``base.py:152-197``)."""
        task = (self.target_task if task_uid is None
                else self.meta_tasks[task_uid])

        config = eval_spec.configuration
        settings = dict(eval_spec.settings)
        context = {} if eval_spec.context is None else dict(eval_spec.context)
        for k, v in task.settings.items():
            settings.setdefault(k, v)
        for k, v in task.context.items():
            context.setdefault(k, v)

        objective_values = self.function(**config, **task.descriptors,
                                         **settings, **context)
        if not isinstance(objective_values, tuple):
            objective_values = (objective_values,)
        assert len(self._objectives) == len(objective_values)
        objectives_dict: Dict[str, Optional[float]] = {
            o.name: v for o, v in zip(self._objectives, objective_values)
        }
        return eval_spec.create_evaluation(objectives=objectives_dict,
                                           user_info={"task_uid": task_uid})

    def get_meta_data(self, distribution: str,
                      seed: Optional[SeedType] = None
                      ) -> Dict[Union[str, int], List[Evaluation]]:
        """Evaluations of each meta task at ``n_data_per_task`` points drawn
        ``random`` or scrambled-``sobol`` (reference ``base.py:199-235``)."""
        prng = np.random.default_rng(seed)
        sobol = Sobol(d=len(self.search_space), scramble=True, seed=prng)

        meta_data: Dict[Union[str, int], List[Evaluation]] = {}
        for uid, n_data in zip(self.meta_tasks, self._n_data_per_task):
            if distribution not in ("random", "sobol"):
                raise ValueError(
                    f"Unknown distribution {distribution}, pick 'sobol' or "
                    f"'random'.")
            meta_data[uid] = []
            for _ in range(n_data):
                if distribution == "random":
                    config = self.search_space.sample(rng=prng)
                else:
                    vector = sobol.random().flatten()
                    config = self.search_space.from_numerical(vector)
                eval_spec = EvaluationSpecification(configuration=config)
                meta_data[uid].append(self.__call__(eval_spec, task_uid=uid))
        return meta_data

    def _numpy_wrapper_call(self, x: np.ndarray, context: Dict[str, Any],
                            settings: Dict[str, Any],
                            task_uid: Optional[Union[str, int]] = None,
                            objective_name: str = "loss"):
        """Scipy-friendly wrapper (reference ``base.py:237-255``)."""
        eval_spec = EvaluationSpecification(
            configuration=self.search_space.from_numerical(x),
            context=context, settings=settings)
        evaluation = self(eval_spec, task_uid=task_uid)
        return evaluation.objectives[objective_name]


def get_minimum(benchmark: Base, task_uid=None):
    """Ground-truth optimum via SHGO (reference ``base.py:258-268``)."""
    task = (benchmark.target_task if task_uid is None
            else benchmark.meta_tasks[task_uid])
    func = functools.partial(benchmark._numpy_wrapper_call, task_uid=task_uid,
                             context=task.context, settings=task.settings)
    result = _shgo_minimize(func, benchmark.search_space)
    return result.fun
