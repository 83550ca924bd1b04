"""HMC and NUTS over GP hyperparameters (``scamlgp_tpu/models/hmc.py``).

A fixed-trajectory HMC sampler with dual-averaging step-size adaptation and
a diagonal mass matrix estimated over the warmup, and a NUTS-style sampler
that doubles its trajectory with multinomial state selection.  The JAX
package writes both for one chain and maps them over chains with ``vmap``;
here chains (and any study axes in front of them) are the leading axes of
one batch, and every log-density evaluation serves the whole batch at once.
NUTS runs lock-step: the batch loops while any chain's trajectory is still
growing, and the updates of a chain that has stopped are masked out, as
``vmap`` of a ``while_loop`` does.

Everything runs in unconstrained (raw) space; ``log_prob_fn`` is the MAP
objective's negative (MLL + priors on constrained values).

Random numbers are inputs: ``hmc`` takes ``HMCDraws`` and ``nuts``
``NUTSDraws``, each with the batch axes first, and ``hmc_draws`` /
``nuts_draws`` make them from a ``torch.Generator``.  Parameters are flat
in the order of their NamedTuple fields (for ``TargetParams``:
``raw_weights``, then ``raw_lengthscale``, ``raw_outputscale``,
``raw_noise``), the JAX package's leaf order.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m

# dual averaging (Hoffman & Gelman 2014, alg. 5)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75
#: a NUTS step whose energy drops by more than this diverges
_DIVERGENCE = 1000.0


class HMCState(NamedTuple):
    """One transition's state of every chain: (B, D) or (B,) leaves."""

    position: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor      # diagonal inverse mass
    log_step_avg: torch.Tensor  # dual averaging state
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


class HMCDraws(NamedTuple):
    """HMC's random inputs, T = num_warmup + num_samples transitions."""

    momentum: torch.Tensor   # (*batch, T, D) standard normal
    uniform: torch.Tensor    # (*batch, T) accept uniforms


class NUTSDraws(NamedTuple):
    """NUTS's random inputs, T transitions of at most K = 2^max_depth - 1
    leapfrog steps each; directions are +1 or -1."""

    momentum: torch.Tensor    # (*batch, T, D) standard normal
    direction0: torch.Tensor  # (*batch, T) the first subtree's direction
    pick: torch.Tensor        # (*batch, T, K) multinomial pick uniforms
    direction: torch.Tensor   # (*batch, T, K) the next subtree's direction


def _direction(u: torch.Tensor) -> torch.Tensor:
    """+1 where a uniform draw is below 1/2 (``jax.random.bernoulli``),
    else -1."""
    return torch.where(u < 0.5, 1.0, -1.0).to(u.dtype)


def hmc_draws(generator: torch.Generator, batch_shape, num_transitions: int,
              dim: int, dtype=torch.float64, device=None) -> HMCDraws:
    batch = tuple(batch_shape)
    mom = torch.randn(batch + (num_transitions, dim), generator=generator,
                      dtype=dtype, device=generator.device)
    u = torch.rand(batch + (num_transitions,), generator=generator,
                   dtype=dtype, device=generator.device)
    return HMCDraws(momentum=mom.to(device), uniform=u.to(device))


def nuts_draws(generator: torch.Generator, batch_shape, num_transitions: int,
               dim: int, max_depth: int, dtype=torch.float64,
               device=None) -> NUTSDraws:
    batch = tuple(batch_shape) + (num_transitions,)
    K = 2 ** max_depth - 1
    g = generator
    mom = torch.randn(batch + (dim,), generator=g, dtype=dtype,
                      device=g.device)
    dir0 = torch.rand(batch, generator=g, dtype=dtype, device=g.device)
    pick = torch.rand(batch + (K,), generator=g, dtype=dtype, device=g.device)
    dirs = torch.rand(batch + (K,), generator=g, dtype=dtype, device=g.device)
    return NUTSDraws(momentum=mom.to(device),
                     direction0=_direction(dir0).to(device),
                     pick=pick.to(device),
                     direction=_direction(dirs).to(device))


def log_prob_and_grad(log_prob_flat: Callable, q: torch.Tensor):
    """Log-density (B,) and its gradient (B, D) at flat positions q (B, D);
    a non-finite log-density becomes -inf and a non-finite gradient entry
    0.  Row b of the value must depend on row b of q only."""
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        lp = log_prob_flat(q)
        g, = torch.autograd.grad(lp.sum(), q)
    lp, g = lp.detach(), g.detach()
    lp = torch.where(torch.isfinite(lp), lp, -torch.inf)
    g = torch.where(torch.isfinite(g), g, 0.0)
    return lp, g


def _flat_log_prob(log_prob_fn: Callable, init_params, batch_ndim: int):
    """The flat starting positions (B, D), the batch shape, and the
    log-density as a function of flat (B, D) positions."""
    q0 = fit_lib.flatten(init_params, batch_ndim)
    batch = q0.shape[:-1]

    def log_prob_flat(q):
        params = fit_lib.unflatten(q.reshape(batch + q.shape[-1:]),
                                   init_params, batch_ndim)
        return log_prob_fn(params).reshape(-1)

    return q0.reshape(-1, q0.shape[-1]), batch, log_prob_flat


def leapfrog(logp_grad: Callable, q, p, grad, eps, inv_mass, num_steps: int):
    """``num_steps`` leapfrog steps of every row from (q, p) (B, D) with the
    gradient ``grad`` at q, step sizes ``eps`` (B,) and diagonal inverse
    masses (B, D).  Returns (q, p, grad, log-density) at the end."""
    eps = eps[..., None]
    lp = None
    for _ in range(num_steps):
        p = p + 0.5 * eps * grad
        q = q + eps * inv_mass * p
        lp, grad = logp_grad(q)
        p = p + 0.5 * eps * grad
    return q, p, grad, lp


def _hmc_step(logp_grad, state: HMCState, momentum, uniform,
              num_leapfrog: int, adapt: bool, target_accept: float,
              welford):
    """One transition of every chain, then the dual-averaging update (when
    ``adapt``) and the Welford update at the new positions."""
    p0 = momentum / torch.sqrt(state.inv_mass)
    # the log-density and gradient at the trajectory's end are the
    # leapfrog's last evaluation: evaluating them again at q1, as the JAX
    # package does, gives the same values
    q1, p1, g1, lp1 = leapfrog(logp_grad, state.position, p0, state.grad,
                               state.step_size, state.inv_mass, num_leapfrog)
    ke0 = 0.5 * torch.sum(p0 * p0 * state.inv_mass, dim=-1)
    ke1 = 0.5 * torch.sum(p1 * p1 * state.inv_mass, dim=-1)
    log_accept = (lp1 - ke1) - (state.log_prob - ke0)
    one = torch.ones_like(log_accept)
    # minimum, not clamp: NaN propagates as jnp.minimum's does
    accept_prob = torch.minimum(one, torch.exp(torch.minimum(
        log_accept, torch.zeros_like(log_accept))))
    accepted = (uniform < accept_prob) & torch.isfinite(lp1)
    q = torch.where(accepted[..., None], q1, state.position)
    lp = torch.where(accepted, lp1, state.log_prob)
    g = torch.where(accepted[..., None], g1, state.grad)

    t = state.t + 1.0
    h_avg, log_step_avg = state.h_avg, state.log_step_avg
    if adapt:
        h_avg = ((1.0 - 1.0 / (t + _T0)) * h_avg
                 + (target_accept - accept_prob) / (t + _T0))
        log_step = state.mu - torch.sqrt(t) / _GAMMA * h_avg
        eta = t ** (-_KAPPA)
        log_step_avg = eta * log_step + (1 - eta) * log_step_avg
        step_size = torch.exp(log_step)
    else:
        step_size = torch.exp(log_step_avg)

    w_n, w_mean, w_m2 = welford
    w_n2 = w_n + 1.0
    delta = q - w_mean
    w_mean2 = w_mean + delta / w_n2[..., None]
    w_m22 = w_m2 + delta * (q - w_mean2)
    new = HMCState(position=q, log_prob=lp, grad=g, step_size=step_size,
                   inv_mass=state.inv_mass, log_step_avg=log_step_avg,
                   h_avg=h_avg, mu=state.mu, t=t)
    return new, (w_n2, w_mean2, w_m22), accept_prob


def hmc(log_prob_fn: Callable, init_params, draws: HMCDraws,
        num_warmup: int = 200, num_samples: int = 200,
        num_leapfrog: int = 16, target_accept: float = 0.8,
        init_step_size: float = 0.1, batch_ndim: int = 0):
    """HMC of every chain of a batch, all chains in one evaluation a step.

    Args:
        log_prob_fn: params (leaves with ``batch_ndim`` leading axes) ->
            log-density with those axes.
        init_params: the chains' starting points.
        draws: ``HMCDraws`` of ``num_warmup + num_samples`` transitions,
            batch axes first.
        batch_ndim: the number of leading (chain, study) axes.

    Returns:
        (samples with leading (*batch, num_samples) axes, info with
        ``accept_prob`` (*batch, num_samples) and the final ``step_size``
        (*batch,)).

    The warmup adapts the step size by dual averaging (gamma 0.05, t0 10,
    kappa 0.75) and accumulates a Welford variance of the positions; after
    it, the diagonal inverse mass becomes that variance (floored at 1e-6)
    where more than 10 positions went in, and the step size the averaged
    one.
    """
    q0, batch, log_prob_flat = _flat_log_prob(log_prob_fn, init_params,
                                              batch_ndim)
    B, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    T = num_warmup + num_samples
    mom = draws.momentum.reshape(B, T, dim)
    unif = draws.uniform.reshape(B, T)

    def logp_grad(q):
        return log_prob_and_grad(log_prob_flat, q)

    lp0, g0 = logp_grad(q0)

    def full(v):
        return torch.full((B,), v, dtype=dtype, device=dev)

    state = HMCState(position=q0, log_prob=lp0, grad=g0,
                     step_size=full(init_step_size),
                     inv_mass=torch.ones((B, dim), dtype=dtype, device=dev),
                     log_step_avg=full(math.log(init_step_size)),
                     h_avg=full(0.0), mu=full(math.log(10.0 * init_step_size)),
                     t=full(0.0))
    welford = (full(0.0), torch.zeros_like(q0), torch.zeros_like(q0))
    for i in range(num_warmup):
        state, welford, _ = _hmc_step(logp_grad, state, mom[:, i], unif[:, i],
                                      num_leapfrog, True, target_accept,
                                      welford)
    w_n, _, w_m2 = welford
    var = w_m2 / torch.clamp_min(w_n - 1.0, 1.0)[..., None]
    inv_mass = torch.where((w_n > 10.0)[..., None], torch.clamp_min(var, 1e-6),
                           state.inv_mass)
    state = state._replace(inv_mass=inv_mass,
                           step_size=torch.exp(state.log_step_avg))
    positions, accs = [], []
    for i in range(num_warmup, T):
        state, welford, acc = _hmc_step(logp_grad, state, mom[:, i],
                                        unif[:, i], num_leapfrog, False,
                                        target_accept, welford)
        positions.append(state.position)
        accs.append(acc)
    return _samples(positions, accs, state.step_size, batch, init_params,
                    batch_ndim)


def _samples(positions, accs, step_size, batch, init_params,
             batch_ndim: int):
    """Stack per-transition (B, D) positions into samples with leading
    (*batch, num_samples) axes."""
    pos = torch.stack(positions, dim=1)
    samples = fit_lib.unflatten(pos.reshape(batch + pos.shape[1:]),
                                init_params, batch_ndim)
    info = {"accept_prob": torch.stack(accs, dim=1).reshape(
        batch + (len(accs),)), "step_size": step_size.reshape(batch)}
    return samples, info


def _trajectory(logp_grad, q, lp, grad, eps, momentum, direction0, pick,
                direction, max_depth: int):
    """One adaptive-trajectory transition of every chain from (q, lp, grad)
    (B, D), (B,), (B, D) with step sizes ``eps`` (B,): the trajectory
    doubles (1, 2, 4, ... leapfrog steps a subtree, a drawn direction a
    subtree) until a U-turn between its ends on a subtree's completion, a
    divergence, or ``max_depth`` doublings.  The chosen state is a
    progressive multinomial draw proportional to exp(H - H0) over every
    visited state.  Chains step together while any still runs; a stopped
    chain's state no longer changes.  Returns (q, log-density, gradient,
    mean acceptance statistic) at the chosen states."""
    B = q.shape[0]
    dtype, dev = q.dtype, q.device
    p0 = momentum
    h0 = lp - 0.5 * torch.sum(p0 * p0, dim=-1)
    eps = eps[..., None]
    zeros = torch.zeros(B, dtype=dtype, device=dev)
    ones_i = torch.ones(B, dtype=torch.long, device=dev)
    s = dict(ql=q, pl=p0, gl=grad, qr=q, pr=p0, gr=grad, qp=q, lpp=lp,
             logW=zeros, direction=direction0, steps_left=ones_i,
             subtree=ones_i, depth=torch.zeros_like(ones_i),
             stop=torch.zeros(B, dtype=torch.bool, device=dev),
             acc_sum=zeros, acc_cnt=zeros)
    j = 0
    while True:
        active = ~s["stop"] & (s["depth"] < max_depth)
        if not bool(active.any()):   # the loop's one host sync a step
            break
        sign = s["direction"][..., None]
        right = sign > 0
        qe = torch.where(right, s["qr"], s["ql"])
        pe = torch.where(right, s["pr"], s["pl"])
        ge = torch.where(right, s["gr"], s["gl"])
        pe = pe + 0.5 * sign * eps * ge
        qe = qe + sign * eps * pe
        lpe, ge = logp_grad(qe)
        pe = pe + 0.5 * sign * eps * ge
        h = lpe - 0.5 * torch.sum(pe * pe, dim=-1)
        w = h - h0
        diverged = (h0 - h) > _DIVERGENCE

        logW_new = torch.logaddexp(s["logW"], w)
        take = (pick[:, j] < torch.exp(w - logW_new)) & ~diverged
        qp = torch.where(take[..., None], qe, s["qp"])
        lpp = torch.where(take, lpe, s["lpp"])
        ql = torch.where(right, s["ql"], qe)
        pl = torch.where(right, s["pl"], pe)
        gl = torch.where(right, s["gl"], ge)
        qr = torch.where(right, qe, s["qr"])
        pr = torch.where(right, pe, s["pr"])
        gr = torch.where(right, ge, s["gr"])

        acc = torch.minimum(torch.ones_like(w), torch.exp(
            torch.minimum(w, torch.zeros_like(w))))
        steps_left = s["steps_left"] - 1
        subtree_done = steps_left == 0
        # on a subtree's completion: the U-turn check and the next doubling
        dq = qr - ql
        uturn = ((torch.sum(dq * pl, dim=-1) < 0)
                 | (torch.sum(dq * pr, dim=-1) < 0))
        subtree = torch.where(subtree_done, s["subtree"] * 2, s["subtree"])
        new = dict(
            ql=ql, pl=pl, gl=gl, qr=qr, pr=pr, gr=gr, qp=qp, lpp=lpp,
            logW=logW_new,
            direction=torch.where(subtree_done, direction[:, j],
                                  s["direction"]),
            steps_left=torch.where(subtree_done, subtree, steps_left),
            subtree=subtree,
            depth=torch.where(subtree_done, s["depth"] + 1, s["depth"]),
            stop=s["stop"] | diverged | (subtree_done & uturn),
            acc_sum=s["acc_sum"] + acc, acc_cnt=s["acc_cnt"] + 1.0)
        for k, v in new.items():
            mask = active[..., None] if v.ndim == 2 else active
            s[k] = torch.where(mask, v, s[k])
        j += 1
    qp, lpp = s["qp"], s["lpp"]
    _, gp_ = logp_grad(qp)
    accept_stat = s["acc_sum"] / torch.clamp_min(s["acc_cnt"], 1.0)
    return qp, lpp, gp_, accept_stat


def nuts(log_prob_fn: Callable, init_params, draws: NUTSDraws,
         num_warmup: int = 200, num_samples: int = 200, max_depth: int = 8,
         target_accept: float = 0.8, init_step_size: float = 0.1,
         batch_ndim: int = 0):
    """NUTS-style adaptive-trajectory sampler of every chain of a batch.

    The trajectory doubles with multinomial state selection until a
    U-turn between its ends (checked on each subtree's completion), a
    divergence or ``max_depth`` doublings; the warmup adapts the step size
    by dual averaging with mu fixed at log(10 * init_step_size), and the
    mass is the identity.  Arguments and returns as ``hmc``'s, with
    ``NUTSDraws`` of ``num_warmup + num_samples`` transitions.
    """
    q, batch, log_prob_flat = _flat_log_prob(log_prob_fn, init_params,
                                             batch_ndim)
    B, dim = q.shape
    dtype, dev = q.dtype, q.device
    T = num_warmup + num_samples
    K = 2 ** max_depth - 1
    mom = draws.momentum.reshape(B, T, dim)
    dir0 = draws.direction0.reshape(B, T)
    pick = draws.pick.reshape(B, T, K)
    dirs = draws.direction.reshape(B, T, K)

    def logp_grad(x):
        return log_prob_and_grad(log_prob_flat, x)

    def transition(q, lp, g, eps, i):
        return _trajectory(logp_grad, q, lp, g, eps, mom[:, i], dir0[:, i],
                           pick[:, i], dirs[:, i], max_depth)

    lp, g = logp_grad(q)
    log_eps = torch.full((B,), math.log(init_step_size), dtype=dtype,
                         device=dev)
    log_eps_avg = log_eps.clone()
    h_avg = torch.zeros(B, dtype=dtype, device=dev)
    t = torch.zeros(B, dtype=dtype, device=dev)
    mu = math.log(10.0 * init_step_size)
    for i in range(num_warmup):
        q, lp, g, acc = transition(q, lp, g, torch.exp(log_eps), i)
        t = t + 1.0
        h_avg = ((1.0 - 1.0 / (t + _T0)) * h_avg
                 + (target_accept - acc) / (t + _T0))
        log_eps = mu - torch.sqrt(t) / _GAMMA * h_avg
        eta = t ** (-_KAPPA)
        log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
    eps = torch.exp(log_eps_avg)
    positions, accs = [], []
    for i in range(num_warmup, T):
        q, lp, g, acc = transition(q, lp, g, eps, i)
        positions.append(q)
        accs.append(acc)
    return _samples(positions, accs, eps, batch, init_params, batch_ndim)


def thin_indices(total: int, take: int) -> list:
    """The indices of ``take`` of ``total`` sample-major interleaved draws,
    spread evenly and anchored at the tail, so that a small mixture keeps
    well-mixed late draws (``take`` = 1 keeps the last draw)."""
    take = min(take, total)
    return sorted(total - 1 - int(round(i * (total - 1) / max(take - 1, 1)))
                  for i in range(take))


def interleave_and_thin(samples, take: int, batch_ndim: int = 0):
    """Samples with leading (*batch, chains, samples) axes, interleaved
    sample-major (sample 0 of every chain, then sample 1, ...) and thinned
    by ``thin_indices`` to leading (*batch, take) axes."""
    def one(leaf):
        lead = leaf.shape[:batch_ndim]
        C, T = leaf.shape[batch_ndim:batch_ndim + 2]
        flat = leaf.transpose(batch_ndim, batch_ndim + 1).reshape(
            lead + (C * T,) + leaf.shape[batch_ndim + 2:])
        idx = torch.as_tensor(thin_indices(C * T, take), device=leaf.device)
        return flat.index_select(batch_ndim, idx)

    return fit_lib.tree_map(one, samples)


def sample_gp_hyperparameters(cfg: gp.GPConfig, X, y, mask,
                              generator: Optional[torch.Generator] = None,
                              num_chains: int = 4, num_warmup: int = 200,
                              num_samples: int = 200, num_leapfrog: int = 16,
                              init: Optional[gp.GPParams] = None,
                              draws: Optional[HMCDraws] = None):
    """Posterior samples of a single-task GP's hyperparameters: one chain
    from each prior draw of ``init`` (made from ``generator`` when left
    out), all chains in one batch.  Returns GPParams with leading
    (chains, samples) axes and ``hmc``'s info."""
    d = X.shape[-1]
    dtype, dev = X.dtype, X.device

    def log_prob(p):
        return gp.mll(cfg, p, X, y, mask) + gp.log_prior(cfg,
                                                         gp.constrain(cfg, p))

    if init is None:
        init = fit_lib.tree_map(
            lambda leaf: leaf.to(dev),
            gp.sample_params(cfg, generator, d, dtype,
                             batch_shape=(num_chains,)))
    if draws is None:
        draws = hmc_draws(generator, (num_chains,), num_warmup + num_samples,
                          fit_lib.flatten(init, 1).shape[-1], dtype, dev)
    return hmc(log_prob, init, draws, num_warmup=num_warmup,
               num_samples=num_samples, num_leapfrog=num_leapfrog,
               batch_ndim=1)


def sample_scamlgp_hyperparameters(model: m.ScaMLGP, target_cfg: gp.GPConfig,
                                   generator: Optional[torch.Generator] = None,
                                   num_chains: int = 4,
                                   num_warmup: int = 200,
                                   num_samples: int = 200,
                                   num_leapfrog: int = 16,
                                   sampler: str = "hmc", max_depth: int = 8,
                                   init: Optional[m.TargetParams] = None,
                                   draws=None):
    """Posterior over the ScaML-GP target parameters (weights + residual
    kernel + noise), conditioned on the frozen source stack: the Bayesian
    alternative to ``fit_scamlgp``'s MAP point.

    ``sampler``: ``"hmc"`` (``num_leapfrog`` steps a transition) or
    ``"nuts"`` (``max_depth`` caps the doubling).  Each chain starts at a
    prior draw of ``init``; ``init`` and the sampler's ``draws`` come from
    ``generator`` when left out, the chain starts first.  Returns
    TargetParams with leading (chains, samples) axes and the sampler's
    info.
    """
    if sampler not in ("hmc", "nuts"):
        raise ValueError(f"unknown sampler {sampler!r} (hmc | nuts)")
    M, d = model.num_tasks, model.train_X.shape[-1]
    dtype, dev = model.train_X.dtype, model.train_X.device

    def log_prob(p):
        return -m.scamlgp_map_objective(model, target_cfg, p)

    if init is None:
        init = fit_lib.tree_map(
            lambda leaf: leaf.to(dev),
            m.sample_target_params(target_cfg, generator, M, d, dtype,
                                   batch_shape=(num_chains,)))
    T, D = num_warmup + num_samples, M + d + 2
    if sampler == "nuts":
        if draws is None:
            draws = nuts_draws(generator, (num_chains,), T, D, max_depth,
                               dtype, dev)
        return nuts(log_prob, init, draws, num_warmup=num_warmup,
                    num_samples=num_samples, max_depth=max_depth,
                    batch_ndim=1)
    if draws is None:
        draws = hmc_draws(generator, (num_chains,), T, D, dtype, dev)
    return hmc(log_prob, init, draws, num_warmup=num_warmup,
               num_samples=num_samples, num_leapfrog=num_leapfrog,
               batch_ndim=1)


def mixture_moments(means, variances, dim: int = 0):
    """Moments of an equal-weight Gaussian mixture over axis ``dim``:
    mean = E[mu], var = E[var + mu^2] - mean^2."""
    mean = torch.mean(means, dim=dim)
    var = torch.mean(variances + means ** 2, dim=dim) - mean ** 2
    return mean, var


def mixture_diag(model: m.ScaMLGP, source_cfg: gp.GPConfig,
                 target_cfg: gp.GPConfig, params: m.TargetParams, Xq):
    """Posterior predictive marginals at Xq (Q, d) averaged over the draws
    ``params`` (leaves with one leading axis of K draws), each draw's
    predictive by joint conditioning, all K x Q at once.  Returns (mean,
    var), each (Q,), var floored at 0."""
    per_draw = fit_lib.tree_map(lambda leaf: leaf.unsqueeze(1), params)
    means, variances = m.scamlgp_posterior_diag(
        model._replace(params=per_draw), source_cfg, target_cfg, Xq)
    mean, var = mixture_moments(means, variances)
    return mean, torch.clamp_min(var, 0.0)


def posterior_mixture_diag(model: m.ScaMLGP, source_cfg: gp.GPConfig,
                           target_cfg: gp.GPConfig, samples, Xq,
                           max_samples: int = 64):
    """``mixture_diag`` over the first ``max_samples`` of samples with
    leading (chains, samples) axes, chain-major."""
    flat = fit_lib.tree_map(
        lambda leaf: leaf.reshape((-1,) + leaf.shape[2:])[:max_samples],
        samples)
    return mixture_diag(model, source_cfg, target_cfg, flat, Xq)
