"""Batched ARD kernel (Gram) assembly (``scamlgp_tpu/ops/kernels.py:35-90``).

    ||x/l - z/l||^2 = |x/l|^2 + |z/l|^2 - 2 (x/l) @ (z/l)^T

so the O(n^2 d) work is one batched matmul.  Batching over studies, tasks
and restarts is leading-dim broadcasting.  A float32 matmul on the card runs
in full float32 (TF32 off), the counterpart of the reference's HIGHEST
precision.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


def _scaled(x, lengthscale):
    """x: (..., n, d); lengthscale: (..., d) or scalar — broadcast divide."""
    if isinstance(lengthscale, torch.Tensor) and lengthscale.ndim >= 1:
        return x / lengthscale.unsqueeze(-2)
    return x / lengthscale


def sq_dist(x, z, lengthscale):
    """Pairwise squared distance of ARD-scaled inputs. (..., n, m)."""
    xs = _scaled(x, lengthscale)
    zs = _scaled(z, lengthscale)
    x2 = torch.sum(xs * xs, dim=-1, keepdim=True)          # (..., n, 1)
    z2 = torch.sum(zs * zs, dim=-1, keepdim=True)          # (..., m, 1)
    cross = torch.matmul(xs, zs.transpose(-1, -2))         # (..., n, m)
    d2 = x2 - 2.0 * cross + z2.transpose(-1, -2)
    return torch.clamp_min(d2, 0.0)


def _outputscale(outputscale):
    """(...,) outputscale -> (..., 1, 1) so it scales each Gram."""
    if isinstance(outputscale, torch.Tensor) and outputscale.ndim >= 1:
        return outputscale[..., None, None]
    return outputscale


def rbf(x, z, lengthscale, outputscale=1.0):
    """ScaleKernel(RBFKernel(ard))."""
    return _outputscale(outputscale) * torch.exp(
        -0.5 * sq_dist(x, z, lengthscale))


def matern12(x, z, lengthscale, outputscale=1.0):
    r = torch.sqrt(sq_dist(x, z, lengthscale) + 1e-30)
    return _outputscale(outputscale) * torch.exp(-r)


def matern32(x, z, lengthscale, outputscale=1.0):
    r = torch.sqrt(sq_dist(x, z, lengthscale) + 1e-30)
    return _outputscale(outputscale) * (1.0 + SQRT3 * r) * torch.exp(
        -SQRT3 * r)


def matern52(x, z, lengthscale, outputscale=1.0):
    r = torch.sqrt(sq_dist(x, z, lengthscale) + 1e-30)
    return _outputscale(outputscale) * (
        1.0 + SQRT5 * r + 5.0 / 3.0 * r * r) * torch.exp(-SQRT5 * r)


KERNELS: dict[str, Callable] = {
    "rbf": rbf,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
}


def get_kernel(name: str) -> Callable:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"Unknown kernel '{name}'. Available: {sorted(KERNELS)}")


def gram(name: str, x, z, lengthscale, outputscale=1.0):
    return get_kernel(name)(x, z, lengthscale, outputscale)
