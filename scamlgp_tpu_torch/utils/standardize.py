"""Masked Standardize outcome transform (``scamlgp_tpu/utils/standardize.py``).

BoTorch's ``Standardize``: the std uses Bessel's correction (ddof=1); for
n <= 1 the std is 1.0; stds below 1e-8 are clamped to 1.0.  Mask-aware so
heterogeneous task sizes batch into one tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_MIN_STD = 1e-8


class Standardize(NamedTuple):
    """Frozen affine outcome transform: ``y_std = (y - mean) / std``."""

    mean: torch.Tensor
    std: torch.Tensor

    def transform(self, y):
        return (y - self.mean) / self.std

    def untransform(self, y_std):
        return y_std * self.std + self.mean


def fit_standardize(y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    dim: int = -1) -> Standardize:
    """Fit mean/std over ``dim`` with an optional 1/0 validity mask."""
    if mask is None:
        mask = torch.ones_like(y)
    mask = torch.broadcast_to(mask, y.shape).to(y.dtype)
    n = torch.sum(mask, dim=dim, keepdim=True)
    n_safe = torch.clamp_min(n, 1.0)
    mean = torch.sum(y * mask, dim=dim, keepdim=True) / n_safe
    centered = (y - mean) * mask
    var = torch.sum(centered**2, dim=dim, keepdim=True) / torch.clamp_min(
        n - 1.0, 1.0)
    std = torch.sqrt(var)
    std = torch.where((n <= 1.0) | (std < _MIN_STD), torch.ones_like(std),
                      std)
    mean = torch.where(n < 1.0, torch.zeros_like(mean), mean)
    return Standardize(mean=mean.squeeze(dim), std=std.squeeze(dim))
