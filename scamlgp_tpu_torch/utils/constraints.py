"""Bijective parameter constraints (``scamlgp_tpu/utils/constraints.py``).

Every hyperparameter lives as an unconstrained raw value; a ``Constraint``
maps raw -> constrained inside the objective, so the optimizer needs no
bounds.  Priors are evaluated on the constrained value with no Jacobian
term (gpytorch MAP semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) with no large-x cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Stable inverse of softplus: y + log(-expm1(-y))."""
    return y + torch.log(-torch.expm1(-y))


@dataclasses.dataclass(frozen=True)
class Constraint:
    """Base: identity transform."""

    def forward(self, raw):
        return raw

    def inverse(self, value):
        return value


@dataclasses.dataclass(frozen=True)
class Interval(Constraint):
    """``lower + (upper - lower) * sigmoid(raw)`` (gpytorch ``Interval``)."""

    lower: float
    upper: float
    initial_value: Optional[float] = None

    def forward(self, raw):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(raw)

    def inverse(self, value):
        frac = (value - self.lower) / (self.upper - self.lower)
        frac = torch.clamp(frac, 1e-12, 1.0 - 1e-12)
        return torch.log(frac) - torch.log1p(-frac)


@dataclasses.dataclass(frozen=True)
class GreaterThan(Constraint):
    """``softplus(raw) + lower`` (gpytorch ``GreaterThan``)."""

    lower: float
    initial_value: Optional[float] = None

    def forward(self, raw):
        return softplus(raw) + self.lower

    def inverse(self, value):
        return inv_softplus(torch.clamp_min(value - self.lower, 1e-30))
