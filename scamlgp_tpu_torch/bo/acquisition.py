"""Acquisition functions of posterior moments (``scamlgp_tpu/bo/acquisition.py``).

All acquisitions are maximized by the optimizer; ``maximize=False`` means
the objective is a loss to minimize (the reference's setting, UCB with
beta = 9).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _norm_logpdf(u):
    return -0.5 * u * u - _LOG_SQRT_2PI


@dataclasses.dataclass(frozen=True)
class AcquisitionFunction:
    maximize: bool = False

    def __call__(self, mean, var, best_f=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UpperConfidenceBound(AcquisitionFunction):
    """For minimization: maximize ``-mean + sqrt(beta) * sigma``."""

    beta: float = 9.0

    def __call__(self, mean, var, best_f=None):
        delta = math.sqrt(self.beta) * torch.sqrt(torch.clamp_min(var, 1e-30))
        return mean + delta if self.maximize else -mean + delta


@dataclasses.dataclass(frozen=True)
class ExpectedImprovement(AcquisitionFunction):
    """EI over the incumbent ``best_f``."""

    def __call__(self, mean, var, best_f=None):
        sigma = torch.sqrt(torch.clamp_min(var, 1e-30))
        u = (mean - best_f) / sigma if self.maximize else (best_f - mean) / sigma
        return sigma * (u * torch.special.ndtr(u) + torch.exp(_norm_logpdf(u)))


@dataclasses.dataclass(frozen=True)
class ProbabilityOfImprovement(AcquisitionFunction):
    def __call__(self, mean, var, best_f=None):
        sigma = torch.sqrt(torch.clamp_min(var, 1e-30))
        u = ((mean - best_f) if self.maximize else (best_f - mean)) / sigma
        return torch.special.ndtr(u)


@dataclasses.dataclass(frozen=True)
class LogExpectedImprovement(AcquisitionFunction):
    """Log-EI, computed stably far from the incumbent."""

    def __call__(self, mean, var, best_f=None):
        sigma = torch.sqrt(torch.clamp_min(var, 1e-30))
        u = ((mean - best_f) if self.maximize else (best_f - mean)) / sigma
        log_phi = _norm_logpdf(u)
        near = torch.log(torch.clamp_min(
            u * torch.special.ndtr(u) + torch.exp(log_phi), 1e-300))
        far = (log_phi - torch.log(torch.clamp_min(-u, 1.0))
               + torch.log1p(-1.0 / torch.clamp_min(u**2, 2.0)))
        return torch.where(u > -1.0, near, far) + torch.log(sigma)
