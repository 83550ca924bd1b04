"""Benchmark ABC + Task dataclass (reference
``reference benchmarking/benchmarks/api.py:19-152``)."""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np

from scamlgp_tpu_torch.bo.core import Evaluation, EvaluationSpecification
from scamlgp_tpu_torch.bo.space import ParameterSpace
from scamlgp_tpu_torch.benchmarking.functions.base import Base as FunctionBase

SeedType = Union[int, np.random.SeedSequence, np.random.BitGenerator,
                 np.random.Generator]


class Benchmark(abc.ABC):
    @property
    @abc.abstractmethod
    def target_task(self) -> "Task":
        """The target task."""

    @property
    @abc.abstractmethod
    def meta_tasks(self) -> Dict[Union[str, int], "Task"]:
        """Dictionary of meta tasks keyed by uid."""

    @property
    def function(self) -> FunctionBase:
        """The underlying callable (aka experiment)."""
        raise NotImplementedError()

    @property
    @abc.abstractmethod
    def search_space(self) -> ParameterSpace:
        """The benchmark-specific search space."""

    @property
    @abc.abstractmethod
    def output_dimensions(self) -> int:
        """Number of output dimensions of each evaluation."""

    @abc.abstractmethod
    def get_meta_data(self, distribution: str,
                      seed: Optional[SeedType] = None
                      ) -> Dict[Union[str, int], List[Evaluation]]:
        """Pre-training data: evaluations of each meta task at random/sobol
        points in the search space."""

    @staticmethod
    def create_random_task(uid, descriptors, settings, context,
                           prng=None):
        """Create a task by sampling its parameter spaces."""

    @abc.abstractmethod
    def __call__(self, eval_spec: EvaluationSpecification,
                 task_uid: Optional[Union[str, int]] = None) -> Evaluation:
        """Evaluate the benchmark at the given configuration."""


@dataclass(frozen=True)
class Task:
    uid: Union[str, int]
    """Unique identifier of the task."""
    descriptors: Dict[str, Any]
    """Hidden function parameters — known to the benchmark, not the user."""
    settings: Dict[str, Any]
    """Parameters known to and chosen by the user; constant per task."""
    context: Dict[str, Any]
    """Parameters known to but not chosen by the user; may vary per call."""
