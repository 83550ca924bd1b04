"""1-D quadratic family f(x) = (a (x + b))^2 + c (reference
``benchmarking/functions/quadratic.py:9-29``)."""

from __future__ import annotations

from scamlgp_tpu_torch.benchmarking.functions.base import Base


def quadratic(x, a, b, c):
    """Vectorized quadratic: floats, numpy arrays or torch tensors."""
    return (a * (x + b)) ** 2 + c


class Quadratic(Base):
    def __call__(self, x: float, a: float, b: float, c: float) -> float:
        return float(quadratic(float(x), a, b, c))
