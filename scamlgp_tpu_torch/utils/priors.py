"""Hyperparameter priors: log-density and sampling (``scamlgp_tpu/utils/priors.py``).

Sampling draws from an explicit ``torch.Generator`` and returns a tensor on
the generator's device.  JAX keys and torch generators give different
numbers, so tests hand both packages the same draws instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Prior:
    def log_prob(self, value):
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape=(),
               dtype=torch.float64):
        raise NotImplementedError


def _standard_gamma(alpha: float, shape, generator: torch.Generator,
                    dtype) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's method, with the
    U^(1/alpha) boost for alpha < 1.  Rejected draws are redrawn; each round
    accepts more than 95% of what is left."""
    dev = generator.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator,
                        dtype=torch.float64, device=dev)
        u = torch.rand(todo.numel(), generator=generator,
                       dtype=torch.float64, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if alpha < 1.0:
        u = torch.rand(n, generator=generator, dtype=torch.float64,
                       device=dev)
        out = out * u ** (1.0 / alpha)
    return out.reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    """Gamma(concentration alpha, rate beta) — torch parametrization."""

    concentration: float
    rate: float

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        safe = torch.clamp_min(value, 1e-300)
        return (a * math.log(b) - math.lgamma(a) + (a - 1.0) * torch.log(safe)
                - b * value)

    def sample(self, generator, shape=(), dtype=torch.float64):
        return _standard_gamma(self.concentration, tuple(shape), generator,
                               dtype) / self.rate


@dataclasses.dataclass(frozen=True)
class LogNormal(Prior):
    loc: float
    scale: float

    def log_prob(self, value):
        log_v = torch.log(torch.clamp_min(value, 1e-300))
        z = (log_v - self.loc) / self.scale
        return (-0.5 * z * z - log_v - math.log(self.scale)
                - 0.5 * math.log(2.0 * math.pi))

    def sample(self, generator, shape=(), dtype=torch.float64):
        z = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=generator.device)
        return torch.exp(self.loc + self.scale * z)


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    loc: float
    scale: float

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return (-0.5 * z * z - math.log(self.scale)
                - 0.5 * math.log(2.0 * math.pi))

    def sample(self, generator, shape=(), dtype=torch.float64):
        z = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=generator.device)
        return self.loc + self.scale * z


@dataclasses.dataclass(frozen=True)
class Uniform(Prior):
    low: float
    high: float

    def log_prob(self, value):
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(
            inside, torch.full_like(value, -math.log(self.high - self.low)),
            torch.full_like(value, -math.inf))

    def sample(self, generator, shape=(), dtype=torch.float64):
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)
        return self.low + (self.high - self.low) * u
