"""Acquisition maximization over [0,1]^d (``scamlgp_tpu/bo/optimize.py:47-94``).

A scrambled-Sobol raw sweep on the host (scipy) picks the top-k starts, then
every start runs sigmoid-reparametrized Adam ascent in lock-step.  Starts
and any leading (study) axes are batch axes of one tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from scipy.stats import qmc

# optax.adam defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class AcqOptResult(NamedTuple):
    x: torch.Tensor          # (..., d) best point in [0,1]^d
    value: torch.Tensor      # (...,) acquisition value at x


def sobol_unit(seed: int, n: int, d: int, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """Host-side scrambled Sobol raw samples (scipy QMC)."""
    eng = qmc.Sobol(d=d, scramble=True, seed=seed)
    return torch.as_tensor(eng.random(n), dtype=dtype, device=device)


def logit(x):
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


def ascend(neg_value: Callable, x0: torch.Tensor, num_steps: int, lr: float):
    """Minimize ``neg_value`` over z = logit(x) from x0 (..., d) by Adam
    (optax.adam), each point on its own.  ``neg_value`` maps (..., d) points
    in the unit cube to (...,) values.  Returns the best z seen and its
    value, as the reference's ascent does."""
    z = logit(x0).detach()
    mu = torch.zeros_like(z)
    nu = torch.zeros_like(z)
    best_z = z
    best_v = torch.full(z.shape[:-1], torch.inf, dtype=z.dtype,
                        device=z.device)
    for t in range(1, num_steps + 1):
        zr = z.detach().requires_grad_(True)
        with torch.enable_grad():
            v = neg_value(torch.sigmoid(zr))
            g, = torch.autograd.grad(v.sum(), zr)
        v = v.detach()
        mu = (1.0 - _B1) * g + _B1 * mu
        nu = (1.0 - _B2) * g * g + _B2 * nu
        mu_hat = mu / (1.0 - _B1 ** t)
        nu_hat = nu / (1.0 - _B2 ** t)
        z_new = z + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
        better = torch.isfinite(v) & (v < best_v)
        best_z = torch.where(better[..., None], z, best_z)
        best_v = torch.where(better, v, best_v)
        z = z_new
    with torch.no_grad():
        vf = neg_value(torch.sigmoid(z))
    better = torch.isfinite(vf) & (vf < best_v)
    return (torch.where(better[..., None], z, best_z),
            torch.where(better, vf, best_v))


def top_starts(value: Callable, raw: torch.Tensor, k: int) -> torch.Tensor:
    """The k raw points (..., n, d) with the highest finite ``value``."""
    with torch.no_grad():
        vals = value(raw)
    vals = torch.where(torch.isfinite(vals), vals, -torch.inf)
    idx = torch.topk(vals, k, dim=-1).indices
    return torch.gather(raw, -2, idx[..., None].expand(
        idx.shape + raw.shape[-1:]))


def optimize_acqf(value_fn: Callable, d: int, seed: int,
                  raw_samples: int = 1024, num_restarts: int = 8,
                  num_steps: int = 50, lr: float = 0.05,
                  dtype=torch.float64, device=None,
                  raw: torch.Tensor = None) -> AcqOptResult:
    """Maximize ``value_fn`` ((..., d) -> (...)) over the unit cube.

    ``raw`` (raw_samples, d) replaces the Sobol sweep drawn from ``seed``
    (the integer that stands in for the reference's JAX key).
    """
    if raw is None:
        raw = sobol_unit(seed, raw_samples, d, dtype, device)
    starts = top_starts(value_fn, raw, num_restarts)
    zs, negv = ascend(lambda x: -value_fn(x), starts, num_steps, lr)
    vals = torch.where(torch.isfinite(negv), -negv, -torch.inf)
    best = torch.argmax(vals, dim=-1)
    return AcqOptResult(x=torch.sigmoid(zs[best]), value=vals[best])
