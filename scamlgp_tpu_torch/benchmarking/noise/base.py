"""Noise-model base (reference ``benchmarking/noise/base.py:10-42``)."""

from __future__ import annotations

import abc
from typing import Optional

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.bo.core import Evaluation


class NoiseBase:
    def __init__(self, seed: Optional[SeedType] = None):
        """Owns a seeded ``np.random.default_rng`` for reproducible noise."""
        self._seed = seed
        self.rng = np.random.default_rng(self._seed)

    @abc.abstractmethod
    def __call__(self, evaluation: Evaluation,
                 rng: Optional[np.random.Generator] = None) -> Evaluation:
        """Return a new Evaluation with noise applied to its objectives."""
