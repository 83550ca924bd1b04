"""Gaussian MLL with an analytic matrix-level gradient over an explicit
inverse (``scamlgp_tpu/ops/inverse_mll.py:65-111``).

For mll(A, y) = -1/2 (y^T A^{-1} y + log|A| + n log 2pi) the gradients are

    d mll / dA = 1/2 (alpha alpha^T - A^{-1}),     alpha = A^{-1} y
    d mll / dy = -alpha

so once the forward pass has A^{-1} (which the sweep kernel produces), the
backward pass is one outer product: no triangular solves.

Forward routing, as in the reference (``inverse_mll.py:53-62``): the sweep
(N <= 128) in the step scheme ``sweep_variant`` (``ops/sweep.py``), then,
with ``route_blocked``, the blocked-Cholesky kernel (192 <= N <= 1024), then
the Cholesky inverse.  ``route_blocked`` is the argument form of the
reference's module constant ``_ROUTE_BLOCKED`` and is off by default, as
that constant is; ``sweep_variant`` is the argument form of the reference's
``SCAMLGP_SWEEP_STEP``, ``_PAIR_STEP`` and ``_BLOCKED_MIN_N``.

``route`` forces one forward route at any N, as ``scripts/bench_sweep_n.py``
does by patching those constants (``:70-109``): ``"sweep"``,
``"blocked_chol"`` or ``"chol_inverse"`` (the library Cholesky inverse);
``"auto"`` (the default) routes as above.
"""

from __future__ import annotations

import math

import torch

from scamlgp_tpu_torch.ops import blocked_chol, sweep

_LOG_2PI = math.log(2.0 * math.pi)


#: forward routes of ``route`` (``"auto"``: by N)
ROUTES = ("auto", "sweep", "blocked_chol", "chol_inverse")


def kernel_launches() -> dict:
    """Launches so far of each kernel wrapper of the inverse routes."""
    counts = {}
    for v, n in sweep.sweep_inverse.launches.items():
        counts[sweep.kernel_name(v)] = n
    for v, n in blocked_chol.blocked_chol_inverse.launches.items():
        counts[f"blocked_chol_inverse_{v}"] = n
    return counts


def reset_kernel_launches() -> None:
    for counts in (sweep.sweep_inverse.launches,
                   blocked_chol.blocked_chol_inverse.launches):
        for v in counts:
            counts[v] = 0


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"unknown inverse route {route!r} "
                         f"({' | '.join(ROUTES)})")


def inverse_mll_profitable(N: int, itemsize: int = 4,
                           route_blocked: bool = False,
                           route: str = "auto") -> bool:
    """Whether an inverse route serves this N (else callers use the
    Cholesky MLL, ``linalg.mll``); a forced ``route`` always does."""
    _check_route(route)
    return (route != "auto" or sweep.sweep_profitable(N)
            or blocked_chol.blocked_profitable(N, itemsize, route_blocked))


def _inverse_auto(A: torch.Tensor, route_blocked: bool = False,
                  sweep_variant: str = "select", route: str = "auto"):
    """(A^{-1}, log|A|) of a (B, N, N) batch through the applicable (or
    the forced) route."""
    _check_route(route)
    N = A.shape[-1]
    if route == "sweep" or (route == "auto" and sweep.sweep_profitable(N)):
        return sweep.sweep_inverse(A.contiguous(), sweep_variant)
    if route == "blocked_chol" or (route == "auto" and
                                   blocked_chol.blocked_profitable(
                                       N, A.element_size(), route_blocked)):
        return blocked_chol.blocked_chol_inverse(A.contiguous())
    return sweep.chol_inverse(A)


class MllViaInverse(torch.autograd.Function):
    """Batched Gaussian log-density with the analytic backward pass."""

    @staticmethod
    def forward(ctx, A, y, n_active, route_blocked=False,
                sweep_variant="select", route="auto"):
        batch = A.shape[:-2]
        N = A.shape[-1]
        Ainv, logdet = _inverse_auto(A.reshape(-1, N, N), route_blocked,
                                     sweep_variant, route)
        Ainv = Ainv.reshape(batch + (N, N))
        logdet = logdet.reshape(batch)
        alpha = torch.sum(Ainv * y[..., None, :], dim=-1)
        quad = torch.sum(y * alpha, dim=-1)
        value = -0.5 * (quad + logdet + n_active * _LOG_2PI)
        ctx.save_for_backward(Ainv, alpha)
        ctx.n_active_shape = n_active.shape
        return value

    @staticmethod
    def backward(ctx, g):
        Ainv, alpha = ctx.saved_tensors
        dA = dy = dn = None
        if ctx.needs_input_grad[0]:
            outer = alpha[..., :, None] * alpha[..., None, :]
            dA = (0.5 * g)[..., None, None] * (outer - Ainv)
        if ctx.needs_input_grad[1]:
            dy = -g[..., None] * alpha
        if ctx.needs_input_grad[2]:
            # the cotangent takes n_active's own shape, scalar included
            dn = (-0.5 * _LOG_2PI * g).sum_to_size(ctx.n_active_shape)
        return dA, dy, dn, None, None, None


def mll_via_inverse(A: torch.Tensor, y: torch.Tensor,
                    n_active: torch.Tensor,
                    route_blocked: bool = False,
                    sweep_variant: str = "select",
                    route: str = "auto") -> torch.Tensor:
    """A: (..., n, n) masked SPD system (``linalg.mask_system``); y: (..., n)
    centered targets, zero on padded rows; n_active: (...,) or scalar
    active-row count.  ``route_blocked`` lets 192 <= n <= 1024 take the
    blocked-Cholesky kernel, ``sweep_variant`` picks the sweep's step
    scheme, ``route`` forces a forward route.  Returns (...,)."""
    return MllViaInverse.apply(A, y, n_active, route_blocked, sweep_variant,
                               route)
