"""Branin meta-benchmark (reference
``reference benchmarking/benchmarks/branin.py:14-69``):
descriptors a, b, c; settings r, s; context t; search x1 in [-5,10],
x2 in [0,15]; default 128 tasks x 4 points."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base, get_minimum
from scamlgp_tpu_torch.benchmarking.functions.branin import Branin as BraninFunction
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace


class Branin(Base):
    """Two-dimensional multi-modal Branin with three global minima.
    Reference: https://www.sfu.ca/~ssurjano/branin.html
    """

    def __init__(self, n_data_per_task: Optional[List[int]] = None,
                 seed: Optional[SeedType] = None, **kwargs):
        if n_data_per_task is None:
            n_data_per_task = [4] * 128
        prng = np.random.default_rng(seed)

        descriptors = ParameterSpace()
        descriptors.add(ContinuousParameter("a", (0.5, 1.5)))
        descriptors.add(ContinuousParameter("b", (0.1, 0.15)))
        descriptors.add(ContinuousParameter("c", (1, 2)))

        settings = ParameterSpace()
        settings.add(ContinuousParameter("r", (5, 7)))
        settings.add(ContinuousParameter("s", (8, 12)))

        context = ParameterSpace()
        context.add(ContinuousParameter("t", (0.03, 0.05)))

        search_space = ParameterSpace()
        search_space.add(ContinuousParameter("x1", (-5, 10)))
        search_space.add(ContinuousParameter("x2", (0, 15)))

        target_task, meta_tasks = super().create_tasks(
            descriptors, settings, context, len(n_data_per_task), prng)
        super().__init__(descriptors, settings, context, search_space,
                         target_task, meta_tasks, n_data_per_task, **kwargs)

    @property
    def function(self):
        return BraninFunction()

    @property
    def optimum(self):
        return get_minimum(self)
