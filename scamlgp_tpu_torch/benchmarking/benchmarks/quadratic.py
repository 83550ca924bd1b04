"""1-D quadratic meta-benchmark (reference ``benchmarks/quadratic.py:14-53``):
f(x) = (a (x + b))^2 + c over x in [-1, 1], descriptors a in [0.5, 1.5],
b in [-0.9, 0.9], c in [-1, 1]; analytic optimum c; default 128 tasks x 4
points."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base
from scamlgp_tpu_torch.benchmarking.functions.quadratic import (
    Quadratic as QuadraticFunction,
)
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace


class Quadratic(Base):
    def __init__(self, n_data_per_task: Optional[List[int]] = None,
                 seed: Optional[SeedType] = None, **kwargs):
        if n_data_per_task is None:
            n_data_per_task = [4] * 128
        prng = np.random.default_rng(seed)

        descriptors = ParameterSpace()
        descriptors.add(ContinuousParameter("a", (0.5, 1.5)))
        descriptors.add(ContinuousParameter("b", (-0.9, 0.9)))
        descriptors.add(ContinuousParameter("c", (-1, 1)))

        settings = ParameterSpace()
        context = ParameterSpace()

        search_space = ParameterSpace()
        search_space.add(ContinuousParameter("x", (-1, 1)))

        target_task, meta_tasks = super().create_tasks(
            descriptors, settings, context, len(n_data_per_task), prng)
        super().__init__(descriptors, settings, context, search_space,
                         target_task, meta_tasks, n_data_per_task, **kwargs)

    @property
    def function(self):
        return QuadraticFunction()

    @property
    def optimum(self):
        """Analytic: min_x (a (x + b))^2 + c = c, as |b| < 1."""
        return self.target_task.descriptors["c"]
