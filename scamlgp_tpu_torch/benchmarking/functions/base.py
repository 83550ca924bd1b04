"""Abstract synthetic-function interface (reference
``reference benchmarking/functions/base.py``).

Functions are pure stateless callables over keyword scalars.  Unlike the
reference's scalar-only implementations, every function here also exposes a
vectorized ``batch(X, **params)`` path (numpy arrays or torch tensors) so benchmark
campaigns can evaluate whole candidate batches on device.
"""

from __future__ import annotations

import abc
from typing import Tuple, Union


class Base(abc.ABC):
    @abc.abstractmethod
    def __call__(self, **kwargs) -> Union[float, Tuple[float]]:
        """Evaluate at a single point given all parameters as kwargs."""
