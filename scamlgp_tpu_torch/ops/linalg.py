"""Masked Cholesky / MLL / GP-conditioning primitives
(``scamlgp_tpu/ops/linalg.py:28-121``) on ``torch.linalg``.

Masking: for a pad index i (mask 0) the system matrix row/col becomes the
identity row and y_i = 0, so padded entries add exactly 0 to the quadratic
form and the log-determinant, and the factorization stays well defined.

A system that is not positive definite factors to NaN, as XLA's Cholesky
does, instead of raising: a line search may probe such points, and the
NaN objective makes it back off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from scamlgp_tpu_torch.config import jitter_for

_LOG_2PI = math.log(2.0 * math.pi)


def mask_system(K: torch.Tensor, noise, mask: Optional[torch.Tensor]):
    """A = K + (noise + jitter) I on active rows/cols, identity on padded
    ones.  K: (..., n, n); noise: scalar or (...,); mask: (..., n) or None."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    diag_k = torch.diagonal(K, dim1=-2, dim2=-1)                     # (..., n)
    jitter = jitter_for(K.dtype) * (1.0 + torch.mean(torch.abs(diag_k), -1))
    add = (torch.as_tensor(noise, dtype=K.dtype, device=K.device)
           + jitter).unsqueeze(-1)                                   # (..., 1)
    if mask is None:
        return K + add[..., None] * eye
    m = mask.to(K.dtype)
    mm = m[..., :, None] * m[..., None, :]
    off = K * mm * (1.0 - eye)
    new_diag = diag_k * m + add * m + (1.0 - m)
    return off + new_diag[..., None] * eye


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, math.nan), L)


def solve_lower(L: torch.Tensor, B: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """L^{-1} B, or L^{-T} B with ``transpose``."""
    if transpose:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B,
                                             upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


class CholState(NamedTuple):
    """Cached factorization for posterior predictions."""

    chol: torch.Tensor       # (..., n, n) lower Cholesky of masked system
    alpha: torch.Tensor      # (..., n) A^{-1} y (zero on padded rows)
    y: torch.Tensor          # (..., n) training targets (standardized space)
    mask: torch.Tensor       # (..., n)


def cholesky_factor(K, noise, y, mask=None) -> CholState:
    A = mask_system(K, noise, mask)
    L = cholesky(A)
    if mask is None:
        mask = torch.ones(K.shape[:-1], dtype=K.dtype, device=K.device)
    ym = y * mask
    ym = ym.expand(L.shape[:-1])
    alpha = solve_lower(L, ym[..., None])
    alpha = solve_lower(L, alpha, transpose=True)[..., 0]
    return CholState(chol=L, alpha=alpha * mask, y=ym, mask=mask)


def mll(K, noise, y, mask=None, mean: Optional[torch.Tensor] = None):
    """Masked Gaussian-process marginal log-likelihood log N(y | mean, A)."""
    if mean is not None:
        y = y - mean
    state = cholesky_factor(K, noise, y, mask)
    quad = torch.sum(state.y * state.alpha, dim=-1)
    diag = torch.diagonal(state.chol, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(diag), dim=-1)
    n_active = torch.sum(state.mask, dim=-1)
    return -0.5 * (quad + logdet + n_active * _LOG_2PI)


def posterior(state: CholState, Kxq, Kqq_diag=None, Kqq=None):
    """Exact GP predictive given a cached factorization.

    Kxq: (..., n, q) prior cross-covariance (padded rows zeroed here);
    Kqq_diag: (..., q) or Kqq: (..., q, q).  Returns the mean (..., q) and
    the variance (..., q) or covariance (..., q, q).
    """
    Kxq = Kxq * state.mask[..., :, None]
    mean = torch.sum(Kxq * state.alpha[..., :, None], dim=-2)
    v = solve_lower(state.chol, Kxq)
    if Kqq is not None:
        return mean, Kqq - torch.matmul(v.transpose(-1, -2), v)
    if Kqq_diag is not None:
        var = Kqq_diag - torch.sum(v * v, dim=-2)
        return mean, torch.clamp_min(var, 0.0)
    return mean
