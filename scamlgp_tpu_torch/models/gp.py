"""Single-task exact GP: zero mean, scaled ARD kernel, Gaussian noise
(``scamlgp_tpu/models/gp.py``).

A GP is data + raw parameters + a static config.  Every function takes
parameters whose leaves may carry leading batch axes (study x task x
restart) and broadcasts them against the data, so restarts, tasks and
studies are batch axes, not Python loops.

Priors and constraints are the reference's:

- source kernel: lengthscale ~ Gamma(3, 6), Interval(1e-4, 1e2, init 0.5);
  outputscale ~ Gamma(2, 0.15), Interval(1e-4, 1e2, init 1.0);
- target kernel: lengthscale ~ LogNormal(0.5, 1.5) (init 1.0); outputscale
  ~ LogNormal(-2, 3) (init 0.1); same Interval bounds;
- noise: LogNormal(-8, 2), Interval(1e-8, 1e-2, init 1e-3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from scamlgp_tpu_torch.ops import inverse_mll
from scamlgp_tpu_torch.ops import kernels as K_ops
from scamlgp_tpu_torch.ops import linalg
from scamlgp_tpu_torch.utils.constraints import Interval
from scamlgp_tpu_torch.utils.priors import Gamma, LogNormal, Prior


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Static GP hyperparameter specification."""

    kernel: str = "rbf"
    lengthscale_constraint: Interval = Interval(1e-4, 1e2, 0.5)
    lengthscale_prior: Prior = Gamma(3.0, 6.0)
    outputscale_constraint: Interval = Interval(1e-4, 1e2, 1.0)
    outputscale_prior: Prior = Gamma(2.0, 0.15)
    noise_constraint: Interval = Interval(1e-8, 1e-2, 1e-3)
    noise_prior: Prior = LogNormal(-8.0, 2.0)


def source_gp_config(kernel: str = "rbf") -> GPConfig:
    """Priors/constraints of the source GPs."""
    return GPConfig(kernel=kernel)


def target_gp_config(kernel: str = "rbf") -> GPConfig:
    """Looser residual-signal priors of the target GP."""
    return GPConfig(
        kernel=kernel,
        lengthscale_constraint=Interval(1e-4, 1e2, 1.0),
        lengthscale_prior=LogNormal(0.5, 1.5),
        outputscale_constraint=Interval(1e-4, 1e2, 0.1),
        outputscale_prior=LogNormal(-2.0, 3.0),
    )


class GPParams(NamedTuple):
    """Raw (unconstrained) hyperparameters; leaves may carry batch dims."""

    raw_lengthscale: torch.Tensor  # (..., d)
    raw_outputscale: torch.Tensor  # (...,)
    raw_noise: torch.Tensor        # (...,)


def init_params(cfg: GPConfig, ard_dims: int, dtype=torch.float32,
                device=None, batch_shape=()) -> GPParams:
    """Initial values from the constraints' ``initial_value``."""
    batch_shape = tuple(batch_shape)

    def full(shape, v):
        return torch.full(batch_shape + shape, v, dtype=dtype, device=device)

    return GPParams(
        raw_lengthscale=cfg.lengthscale_constraint.inverse(
            full((ard_dims,), cfg.lengthscale_constraint.initial_value)),
        raw_outputscale=cfg.outputscale_constraint.inverse(
            full((), cfg.outputscale_constraint.initial_value)),
        raw_noise=cfg.noise_constraint.inverse(
            full((), cfg.noise_constraint.initial_value)),
    )


def sample_params(cfg: GPConfig, generator: torch.Generator, ard_dims: int,
                  dtype=torch.float32, batch_shape=()) -> GPParams:
    """Prior-sampled restart initializations with leading ``batch_shape``,
    on the generator's device.  Draws are clipped into each constraint's
    open interval so the inverse transform is finite."""
    batch_shape = tuple(batch_shape)
    ls = cfg.lengthscale_prior.sample(generator, batch_shape + (ard_dims,),
                                      dtype)
    os_ = cfg.outputscale_prior.sample(generator, batch_shape, dtype)
    nz = cfg.noise_prior.sample(generator, batch_shape, dtype)

    def raw(c: Interval, v):
        span = c.upper - c.lower
        return c.inverse(torch.clamp(v, c.lower + 1e-10 * span,
                                     c.upper - 1e-6 * span))

    return GPParams(raw_lengthscale=raw(cfg.lengthscale_constraint, ls),
                    raw_outputscale=raw(cfg.outputscale_constraint, os_),
                    raw_noise=raw(cfg.noise_constraint, nz))


class Constrained(NamedTuple):
    lengthscale: torch.Tensor
    outputscale: torch.Tensor
    noise: torch.Tensor


def constrain(cfg: GPConfig, p: GPParams) -> Constrained:
    return Constrained(
        lengthscale=cfg.lengthscale_constraint.forward(p.raw_lengthscale),
        outputscale=cfg.outputscale_constraint.forward(p.raw_outputscale),
        noise=cfg.noise_constraint.forward(p.raw_noise),
    )


def log_prior(cfg: GPConfig, c: Constrained) -> torch.Tensor:
    """Sum of prior log-densities on constrained values (gpytorch MAP terms)."""
    return (torch.sum(cfg.lengthscale_prior.log_prob(c.lengthscale), dim=-1)
            + cfg.outputscale_prior.log_prob(c.outputscale)
            + cfg.noise_prior.log_prob(c.noise))


def gram(cfg: GPConfig, c: Constrained, x, z=None):
    z = x if z is None else z
    return K_ops.gram(cfg.kernel, x, z, c.lengthscale, c.outputscale)


def mll(cfg: GPConfig, p: GPParams, X, y, mask=None,
        prior_mean=None, prior_cov=None, method: str = "chol",
        route_blocked: bool = False, sweep_variant: str = "select",
        inverse_route: str = "auto") -> torch.Tensor:
    """Marginal log-likelihood log N(y | prior_mean, K + prior_cov + noise I).

    Methods:

    - ``"chol"``: Cholesky MLL with autograd (the parity path);
    - ``"sweep"``: the inverse route with the analytic gradient
      (``ops/inverse_mll.py``), through the sweep kernel of step scheme
      ``sweep_variant`` for N <= 128 and, with ``route_blocked``, the
      blocked-Cholesky kernel for 192 <= N <= 1024; falls back to
      ``"chol"`` where no inverse route serves this N.  ``inverse_route``
      other than ``"auto"`` forces one forward route at every N
      (``inverse_mll.ROUTES``), as the kernel N-scaling bench does;
    - ``"chol64"``: a float64 island for ill-conditioned float32 systems:
      the parameters are constrained, the Gram assembled from the inputs
      and the prior covariance added, all in float64, the system factored
      in float64, and the MLL cast back to ``X.dtype``.  The island starts
      at the inputs, not at the factorization: a Gram assembled in float32
      already carries float32 rounding that an exact factorization cannot
      undo.  The card computes float64 natively, so no mode switch is
      needed.
    """
    if method not in ("chol", "sweep", "chol64"):
        raise ValueError(f"unknown mll method {method!r} "
                         "(chol | sweep | chol64)")
    if method == "chol64":
        def f64(t):
            return None if t is None else t.to(torch.float64)

        c64 = constrain(cfg, GPParams(*[f64(leaf) for leaf in p]))
        K64 = gram(cfg, c64, f64(X))
        if prior_cov is not None:
            K64 = K64 + f64(prior_cov)
        return linalg.mll(K64, c64.noise, f64(y), mask=f64(mask),
                          mean=f64(prior_mean)).to(X.dtype)
    c = constrain(cfg, p)
    K = gram(cfg, c, X)
    if prior_cov is not None:
        K = K + prior_cov
    if method == "sweep" and inverse_mll.inverse_mll_profitable(
            K.shape[-1], K.element_size(), route_blocked, inverse_route):
        yy = y if prior_mean is None else y - prior_mean
        if mask is not None:
            yy = yy * mask
            n_active = torch.sum(mask, dim=-1)
        else:
            n_active = torch.full((), K.shape[-1], dtype=K.dtype,
                                  device=K.device)
        A = linalg.mask_system(K, c.noise, mask)
        batch = A.shape[:-2]
        return inverse_mll.mll_via_inverse(
            A, yy.expand(batch + yy.shape[-1:]), n_active.expand(batch),
            route_blocked, sweep_variant, inverse_route)
    return linalg.mll(K, c.noise, y, mask=mask, mean=prior_mean)


def map_objective(cfg: GPConfig, p: GPParams, X, y, mask=None,
                  prior_mean=None, prior_cov=None,
                  extra_log_prior=0.0, method: str = "chol",
                  route_blocked: bool = False, sweep_variant: str = "select",
                  inverse_route: str = "auto") -> torch.Tensor:
    """Negative (MLL + log prior) — the quantity minimized during fitting."""
    c = constrain(cfg, p)
    return -(mll(cfg, p, X, y, mask, prior_mean, prior_cov, method=method,
                 route_blocked=route_blocked, sweep_variant=sweep_variant,
                 inverse_route=inverse_route)
             + log_prior(cfg, c) + extra_log_prior)


class PosteriorState(NamedTuple):
    """Cached training factorization for fast repeated predictions."""

    chol_state: linalg.CholState
    constrained: Constrained
    X: torch.Tensor


def condition(cfg: GPConfig, p: GPParams, X, y, mask=None,
              prior_cov=None, prior_mean=None) -> PosteriorState:
    c = constrain(cfg, p)
    K = gram(cfg, c, X)
    if prior_cov is not None:
        K = K + prior_cov
    resid = y if prior_mean is None else y - prior_mean
    state = linalg.cholesky_factor(K, c.noise, resid, mask)
    return PosteriorState(chol_state=state, constrained=c, X=X)


def predict(cfg: GPConfig, ps: PosteriorState, Xq,
            cross_extra=None, query_cov_extra=None, query_mean=None,
            full_cov: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/cov (or var) of the noise-free latent f at ``Xq``."""
    c = ps.constrained
    Kxq = gram(cfg, c, ps.X, Xq)
    if cross_extra is not None:
        Kxq = Kxq + cross_extra
    if full_cov:
        Kqq = gram(cfg, c, Xq)
        if query_cov_extra is not None:
            Kqq = Kqq + query_cov_extra
        mean, cov = linalg.posterior(ps.chol_state, Kxq, Kqq=Kqq)
    else:
        q_diag = torch.broadcast_to(c.outputscale[..., None],
                                    Xq.shape[:-1]).to(Xq.dtype)
        if query_cov_extra is not None:
            q_diag = q_diag + query_cov_extra
        mean, cov = linalg.posterior(ps.chol_state, Kxq, Kqq_diag=q_diag)
    if query_mean is not None:
        mean = mean + query_mean
    return mean, cov
