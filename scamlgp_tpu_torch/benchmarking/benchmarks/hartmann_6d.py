"""Hartmann6D meta-benchmark (reference ``benchmarks/hartmann_6d.py:14-41``):
subclasses Hartmann3D, extends the search space to [0,1]^6."""

from __future__ import annotations

from typing import List, Optional

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.benchmarking.benchmarks.base import get_minimum
from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_3d import Hartmann3D
from scamlgp_tpu_torch.benchmarking.functions.hartmann import (
    Hartmann6D as Hartmann6DFunction,
)
from scamlgp_tpu_torch.bo.space import ContinuousParameter


class Hartmann6D(Hartmann3D):
    """Six-dimensional Hartmann: six local minima, one global minimum.
    Reference: https://www.sfu.ca/~ssurjano/hart6.html
    """

    def __init__(self, n_data_per_task: Optional[List[int]] = None,
                 seed: Optional[SeedType] = None, **kwargs):
        super().__init__(n_data_per_task, seed=seed, **kwargs)
        for name in ("x4", "x5", "x6"):
            self._search_space.add(ContinuousParameter(name, (0, 1)))

    @property
    def function(self):
        return Hartmann6DFunction()

    @property
    def optimum(self):
        return get_minimum(self)
