"""Homoscedastic Gaussian noise (reference
``benchmarking/noise/homoscedastic.py:13-53``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, Optional

from scamlgp_tpu_torch.benchmarking.benchmarks.api import SeedType
from scamlgp_tpu_torch.benchmarking.noise.base import NoiseBase
from scamlgp_tpu_torch.bo.core import Evaluation


class HomoscedasticGaussianNoise(NoiseBase):
    def __init__(self, noise_std: Dict[str, float],
                 seed: Optional[SeedType] = None):
        """I.i.d. Gaussian noise with fixed per-objective scales.

        ``noise_std`` must cover every objective of the paired benchmark; it
        may contain additional unused keys (reference semantics).
        """
        super().__init__(seed)
        self.noise_std = noise_std

    def __call__(self, evaluation: Evaluation, rng=None) -> Evaluation:
        rng = self.rng if rng is None else rng
        tmp_eval = deepcopy(evaluation)
        for k in tmp_eval.objectives.keys():
            try:
                tmp_eval.objectives[k] += rng.normal(scale=self.noise_std[k])
            except KeyError:
                raise KeyError(
                    f"There is no noise for objective '{k}' defined! "
                    "Please add a value to the noise_std parameter.")
        return tmp_eval

    def __repr__(self):
        """Stable repr — part of the hashed experiment config
        (reference noise tests + ``experiment_config_utils.py``)."""
        return (f"{self.__class__.__name__}(noise_std={self.noise_std}, "
                f"seed={self._seed})")
