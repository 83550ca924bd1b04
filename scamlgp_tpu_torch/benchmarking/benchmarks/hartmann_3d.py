"""Hartmann3D meta-benchmark (reference
``benchmarks/hartmann_3d.py:14-64``): descriptors alpha1..alpha4 in narrow
emukit-compatible ranges; search [0,1]^3."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base, get_minimum
from scamlgp_tpu_torch.benchmarking.functions.hartmann import (
    Hartmann3D as Hartmann3DFunction,
)
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace


class Hartmann3D(Base):
    """Three-dimensional Hartmann: four local minima, one global minimum.
    Reference: https://www.sfu.ca/~ssurjano/hart3.html
    """

    def __init__(self, n_data_per_task: Optional[List[int]] = None,
                 seed: Optional[SeedType] = None, **kwargs):
        if n_data_per_task is None:
            n_data_per_task = [4] * 128
        prng = np.random.default_rng(seed)

        descriptors = ParameterSpace()
        descriptors.add(ContinuousParameter("alpha1", (1.0, 1.02)))
        descriptors.add(ContinuousParameter("alpha2", (1.18, 1.2)))
        descriptors.add(ContinuousParameter("alpha3", (2.8, 3.0)))
        descriptors.add(ContinuousParameter("alpha4", (3.2, 3.4)))

        settings = ParameterSpace()
        context = ParameterSpace()

        search_space = ParameterSpace()
        for name in ("x1", "x2", "x3"):
            search_space.add(ContinuousParameter(name, (0, 1)))

        target_task, meta_tasks = super().create_tasks(
            descriptors, settings, context, len(n_data_per_task), prng)
        super().__init__(descriptors, settings, context, search_space,
                         target_task, meta_tasks, n_data_per_task, **kwargs)

    @property
    def function(self):
        return Hartmann3DFunction()

    @property
    def optimum(self):
        return get_minimum(self)
