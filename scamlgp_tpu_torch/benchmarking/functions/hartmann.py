"""Hartmann 3-D / 6-D functions (reference
``benchmarking/functions/hartmann.py:9-188``).

f(x, alpha) = -sum_i alpha_i exp(-sum_j A_ij (x_j - P_ij)^2)
References: https://www.sfu.ca/~ssurjano/hart3.html, hart6.html
"""

from __future__ import annotations

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.functions.base import Base

A3 = np.array([[3.0, 10, 30], [0.1, 10, 35], [3.0, 10, 30], [0.1, 10, 35]])
P3 = 1e-4 * np.array([
    [3689, 1170, 2673],
    [4699, 4387, 7470],
    [1091, 8732, 5547],
    [381, 5743, 8828],
])

A6 = np.array([
    [10, 3, 17, 3.5, 1.7, 8],
    [0.05, 10, 17, 0.1, 8, 14],
    [3, 3.5, 1.7, 10, 17, 8],
    [17, 8, 0.05, 10, 0.1, 14],
])
P6 = 1e-4 * np.array([
    [1312, 1696, 5569, 124, 8283, 5886],
    [2329, 4135, 8307, 3736, 1004, 9991],
    [2348, 1451, 3522, 2883, 3047, 6650],
    [4047, 8828, 8732, 5743, 1091, 381],
])


#: (bytes, shape, dtype, device) -> the constant on the device
_CONSTANTS: dict = {}


def _constant(a, like: torch.Tensor) -> torch.Tensor:
    """The array ``a`` on ``like``'s dtype and device, copied from the host
    once: a copy from the host would wait on it inside a CUDA graph's
    capture (the campaign's device loop)."""
    a = np.asarray(a)
    key = (a.tobytes(), a.shape, like.dtype, like.device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(a, dtype=like.dtype,
                                          device=like.device)
    return _CONSTANTS[key]


def hartmann_function(x, alpha, A, P):
    """Vectorized Hartmann: x (..., d), alpha (..., 4) -> (...,), for numpy
    arrays or torch tensors (A and P follow x's type, dtype and device)."""
    if isinstance(x, torch.Tensor):
        A, P = _constant(A, x), _constant(P, x)
        exp = torch.exp
    else:
        exp = np.exp
    # (..., 4): sum_j A_ij (x_j - P_ij)^2
    expo = exp(-((A * (x[..., None, :] - P) ** 2).sum(-1)))
    return -(alpha * expo).sum(-1)


class Hartmann3D(Base):
    def __call__(self, x1: float, x2: float, x3: float, alpha1: float,
                 alpha2: float, alpha3: float, alpha4: float) -> float:
        x = np.array([x1, x2, x3], dtype=np.float64)
        alpha = np.array([alpha1, alpha2, alpha3, alpha4])
        return float(hartmann_function(x, alpha, A3, P3))


class Hartmann6D(Base):
    def __call__(self, x1: float, x2: float, x3: float, x4: float, x5: float,
                 x6: float, alpha1: float, alpha2: float, alpha3: float,
                 alpha4: float) -> float:
        x = np.array([x1, x2, x3, x4, x5, x6], dtype=np.float64)
        alpha = np.array([alpha1, alpha2, alpha3, alpha4])
        return float(hartmann_function(x, alpha, A6, P6))
