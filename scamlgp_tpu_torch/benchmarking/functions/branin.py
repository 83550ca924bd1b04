"""Branin function (reference ``benchmarking/functions/branin.py:9-42``).

f(x1, x2) = a (x2 - b x1^2 + c x1 - r)^2 + s (1 - t) cos(x1) + s
Reference: https://www.sfu.ca/~ssurjano/branin.html
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.functions.base import Base


def branin(x1, x2, a=1.0, b=5.1 / (4 * math.pi**2), c=5 / math.pi, r=6.0,
           s=10.0, t=1 / (8 * math.pi)):
    """Vectorized Branin — works on floats, numpy arrays or torch tensors."""
    cos = torch.cos if isinstance(x1, torch.Tensor) else np.cos
    return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * cos(x1) + s


class Branin(Base):
    def __call__(self, x1: float, x2: float, a: float = 1,
                 b: float = 5.1 / (4 * math.pi**2), c: float = 5 / math.pi,
                 r: float = 6, s: float = 10,
                 t: float = 1 / (8 * math.pi)) -> float:
        return float(branin(float(x1), float(x2), a, b, c, r, s, t))
