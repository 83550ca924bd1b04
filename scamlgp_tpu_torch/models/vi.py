"""Mean-field ADVI over GP hyperparameters (``scamlgp_tpu/models/vi.py``),
the variational counterpart of ``models/hmc.py``.

The family is a diagonal Gaussian in the unconstrained (raw) parameter
space, the space and target density ``exp(-map_objective)`` that HMC
samples.  Fitting maximizes the reparametrized ELBO

    ELBO(mu, sigma) = E_{eps~N(0,I)}[ log p(mu + sigma*eps) ] + sum log sigma

(+ a constant) with Adam on (mu, log sigma), the gradient clipped to a
global norm of 100 over both (``optax.chain(clip_by_global_norm(100),
adam(lr))``, written out), and a fixed number of Monte-Carlo draws a step.
The draws of a step are one batch: each step is one log-density call.  Any
leading (study) axes of the parameters are batch axes too, each batch
element with its own optimizer state.  Posterior "samples" for the
acquisition mixture are i.i.d. draws from q.

Random numbers are inputs: ``advi`` takes its eps draws and ``sample_q``
its normals; ``vi_draws`` makes both from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from scamlgp_tpu_torch.bo.optimize import _B1, _B2, _EPS
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m

#: optax.clip_by_global_norm's max_norm in the JAX package's optimizer
_MAX_NORM = 100.0
#: the lower clip of log sigma
_MIN_LOG_SIGMA = -8.0


class MeanFieldQ(NamedTuple):
    """Diagonal-Gaussian variational posterior over flat raw parameters."""

    mu: torch.Tensor         # (..., D)
    log_sigma: torch.Tensor  # (..., D)


class VIDraws(NamedTuple):
    """ADVI's random inputs, batch axes first."""

    eps: torch.Tensor      # (*batch, num_steps, num_mc, D) standard normal
    sample: torch.Tensor   # (*batch, num_draws, D) standard normal


def vi_draws(generator: torch.Generator, batch_shape, num_steps: int,
             num_mc: int, num_draws: int, dim: int, dtype=torch.float64,
             device=None) -> VIDraws:
    batch = tuple(batch_shape)
    eps = torch.randn(batch + (num_steps, num_mc, dim), generator=generator,
                      dtype=dtype, device=generator.device)
    sample = torch.randn(batch + (num_draws, dim), generator=generator,
                         dtype=dtype, device=generator.device)
    return VIDraws(eps=eps.to(device), sample=sample.to(device))


def neg_elbo_value_and_grad(log_prob_flat: Callable, q: MeanFieldQ, eps):
    """The reparametrization estimator with per-draw masking, for q with
    (B, D) leaves and draws eps (B, num_mc, D):

        dELBO/dmu     = E[ d logp/dtheta ]
        dELBO/dlogsig = E[ d logp/dtheta * eps * sigma ] + 1

    over the draws whose log-density and gradient are finite only (one
    non-finite draw would otherwise poison the step).  Where no draw is
    finite the value is +inf, so that the step's guard reverts it.
    ``log_prob_flat`` maps (B, num_mc, D) to (B, num_mc).  Returns the
    negative ELBO (B,) and its gradient as a MeanFieldQ."""
    sigma = torch.exp(q.log_sigma)
    theta = (q.mu[..., None, :] + sigma[..., None, :] * eps).detach()
    theta.requires_grad_(True)
    with torch.enable_grad():
        vals = log_prob_flat(theta)
        grads, = torch.autograd.grad(vals.sum(), theta)
    vals, grads = vals.detach(), grads.detach()
    ok = torch.isfinite(vals) & torch.all(torch.isfinite(grads), dim=-1)
    n_ok = torch.sum(ok, dim=-1)
    wt = ok.to(vals.dtype) / torch.clamp_min(n_ok, 1)[..., None]
    grads = torch.where(ok[..., None], grads, 0.0)
    g_mu = -torch.einsum("...s,...sd->...d", wt, grads)
    g_ls = -(torch.einsum("...s,...sd,...sd->...d", wt, grads, eps) * sigma
             + 1.0)
    value = -(torch.sum(wt * torch.where(ok, vals, 0.0), dim=-1)
              + torch.sum(q.log_sigma, dim=-1))
    value = torch.where(n_ok > 0, value, torch.inf)
    return value, MeanFieldQ(mu=g_mu, log_sigma=g_ls)


def _clip_by_global_norm(g: MeanFieldQ) -> MeanFieldQ:
    """optax.clip_by_global_norm(100) per batch element: the norm is over
    both leaves."""
    norm = torch.sqrt(torch.sum(g.mu * g.mu, dim=-1)
                      + torch.sum(g.log_sigma * g.log_sigma, dim=-1))
    keep = (norm < _MAX_NORM)[..., None]
    return MeanFieldQ(*[torch.where(keep, t, (t / norm[..., None]) * _MAX_NORM)
                        for t in g])


def advi(log_prob_fn: Callable, init_params, eps: torch.Tensor,
         lr: float = 0.05, init_log_sigma: float = -2.0,
         max_log_sigma: float = 1.0, batch_ndim: int = 0):
    """Fit a mean-field Gaussian to ``exp(log_prob_fn)`` in raw space.

    Args:
        log_prob_fn: params (leaves with leading (*batch, num_mc) axes) ->
            log-density (*batch, num_mc); the negative MAP objective, as
            with ``hmc``.
        init_params: the variational mean's start, leaves with
            ``batch_ndim`` leading axes (a MAP warm start speeds
            convergence markedly).
        eps: (*batch, num_steps, num_mc, D) reparametrization draws; the
            number of Adam steps and of draws a step are its axes.
        lr: Adam learning rate.
        init_log_sigma: the initial log standard deviation (shared).
        max_log_sigma: per-dimension cap on log sigma.  The raw-space
            target puts priors on constrained values with no bijector
            Jacobian, so it is asymptotically flat along saturated sigmoid
            directions, where the entropy term would push sigma to
            infinity; the cap bounds q there.

    Returns:
        (q, unflatten, info): the fitted MeanFieldQ with (*batch, D)
        leaves; ``unflatten`` maps flat (..., D) vectors back to the
        parameter structure; ``info`` holds ``neg_elbo_trace``
        (*batch, num_steps).

    A step with no finite draw, or whose update or gradient is not
    finite, is skipped (the parameters and the optimizer state are kept);
    log sigma is then clipped to [-8, max_log_sigma].
    """
    mu0 = fit_lib.flatten(init_params, batch_ndim)
    batch, dim = mu0.shape[:-1], mu0.shape[-1]
    B = mu0[..., 0].numel()
    num_steps, num_mc = eps.shape[batch_ndim:batch_ndim + 2]
    eps = eps.reshape(B, num_steps, num_mc, dim)
    q = MeanFieldQ(mu=mu0.reshape(B, dim),
                   log_sigma=torch.full((B, dim), init_log_sigma,
                                        dtype=mu0.dtype, device=mu0.device))

    def unflatten(flat):
        return fit_lib.unflatten(flat, init_params, batch_ndim)

    def log_prob_flat(theta):
        params = fit_lib.unflatten(
            theta.reshape(batch + (num_mc, dim)), init_params, batch_ndim)
        return log_prob_fn(params).reshape(B, num_mc)

    # Adam state (optax.scale_by_adam), per batch element
    m1 = MeanFieldQ(*[torch.zeros_like(t) for t in q])
    m2 = MeanFieldQ(*[torch.zeros_like(t) for t in q])
    count = torch.zeros(B, dtype=mu0.dtype, device=mu0.device)
    trace = []
    for i in range(num_steps):
        v, g = neg_elbo_value_and_grad(log_prob_flat, q, eps[:, i])
        gc = _clip_by_global_norm(g)
        m1n = MeanFieldQ(*[(1.0 - _B1) * a + _B1 * b for a, b in zip(gc, m1)])
        m2n = MeanFieldQ(*[(1.0 - _B2) * a * a + _B2 * b
                           for a, b in zip(gc, m2)])
        cn = count + 1.0
        c1 = (1.0 - _B1 ** cn)[..., None]
        c2 = (1.0 - _B2 ** cn)[..., None]
        q2 = MeanFieldQ(*[p + (a / c1) / (torch.sqrt(b / c2) + _EPS) * (-lr)
                          for p, a, b in zip(q, m1n, m2n)])
        ok = torch.isfinite(v)
        for t in (*q2, *g):
            ok = ok & torch.all(torch.isfinite(t), dim=-1)
        keep = ok[..., None]
        q = MeanFieldQ(*[torch.where(keep, a, b) for a, b in zip(q2, q)])
        m1 = MeanFieldQ(*[torch.where(keep, a, b) for a, b in zip(m1n, m1)])
        m2 = MeanFieldQ(*[torch.where(keep, a, b) for a, b in zip(m2n, m2)])
        count = torch.where(ok, cn, count)
        q = q._replace(log_sigma=torch.clamp(q.log_sigma, _MIN_LOG_SIGMA,
                                             max_log_sigma))
        trace.append(v)
    q = MeanFieldQ(*[t.reshape(batch + (dim,)) for t in q])
    info = {"neg_elbo_trace": torch.stack(trace, dim=-1).reshape(
        batch + (num_steps,))}
    return q, unflatten, info


def sample_q(q: MeanFieldQ, unflatten: Callable, eps: torch.Tensor):
    """Draws mu + sigma * eps from the fitted posterior, eps (*batch, K, D)
    standard normals: the parameter structure with leading (*batch, K)
    axes (the VI analogue of an HMC sample stack)."""
    draws = q.mu[..., None, :] + torch.exp(q.log_sigma)[..., None, :] * eps
    return unflatten(draws)


def fit_scamlgp_vi(model: m.ScaMLGP, target_cfg: gp.GPConfig,
                   generator: Optional[torch.Generator] = None,
                   num_steps: int = 300, num_mc: int = 8, lr: float = 0.05,
                   num_draws: int = 16,
                   init_params: Optional[m.TargetParams] = None,
                   draws: Optional[VIDraws] = None):
    """Variational posterior over the ScaML-GP target parameters (weights
    + residual kernel + noise), conditioned on the frozen source stack:
    the VI sibling of ``hmc.sample_scamlgp_hyperparameters``.  ``draws``
    come from ``generator`` when left out.

    Returns (samples with a leading ``num_draws`` axis, info with the
    fitted ``q`` and the ELBO trace).
    """
    M, d = model.num_tasks, model.train_X.shape[-1]
    dtype, dev = model.train_X.dtype, model.train_X.device

    def log_prob(p):
        return -m.scamlgp_map_objective(model, target_cfg, p)

    init = (init_params if init_params is not None
            else m.init_target_params(target_cfg, M, d, dtype, dev))
    if draws is None:
        draws = vi_draws(generator, (), num_steps, num_mc, num_draws,
                         M + d + 2, dtype, dev)
    q, unflatten, info = advi(log_prob, init, draws.eps, lr=lr)
    samples = sample_q(q, unflatten, draws.sample)
    return samples, {**info, "q": q}
