"""ScaML-GP — hierarchical sum-of-GPs meta-model (``scamlgp_tpu/models/scamlgp.py``).

One independent source GP per meta-task; the target GP's prior is the
weighted source posterior

    mu_s(x)       = sum_i w_i mu_i(x)
    Sigma_s(x,x') = sum_i w_i^2 Sigma_i(x,x')

plus a residual target kernel; the weights are learned with the target MLL.

Source GPs are one batched stack: data padded to a common N with masks,
parameters with a leading task axis (and any leading study axes in front of
it).  Weight pruning is a multiplicative 0/1 mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import linalg
from scamlgp_tpu_torch.utils.constraints import inv_softplus, softplus
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER
from scamlgp_tpu_torch.utils.priors import Gamma
from scamlgp_tpu_torch.utils.standardize import fit_standardize

WEIGHTS_PRIOR = Gamma(1.0, 1.0)
WEIGHTS_LOWER_BOUND = 1e-10
DEFAULT_PRUNING_THRESHOLD = 1e-3


# ---------------------------------------------------------------------------
# Source stack
# ---------------------------------------------------------------------------

class TaskData(NamedTuple):
    """Meta-task observations, padded and stacked over the task axis."""

    X: torch.Tensor      # (..., M, N, d) unit-cube inputs
    y: torch.Tensor      # (..., M, N) per-task standardized targets
    mask: torch.Tensor   # (..., M, N) 1 = real observation, 0 = pad
    mean: torch.Tensor   # (..., M) per-task Standardize mean
    std: torch.Tensor    # (..., M) per-task Standardize std


class SourceStack(NamedTuple):
    """Fitted source GPs: data + MAP hyperparameters + cached factorizations."""

    data: TaskData
    params: gp.GPParams          # leaves with the (..., M) axes
    chol: torch.Tensor           # (..., M, N, N)
    alpha: torch.Tensor          # (..., M, N)  A^-1 y_std

    @property
    def num_tasks(self) -> int:
        return self.data.X.shape[-3]


def pack_task_data(xs, ys, dtype=torch.float64, device=None) -> TaskData:
    """Pad per-task (X_i, y_i) arrays to a common N and standardize each
    task's Y (the reference's per-task ``Standardize``)."""
    m = len(xs)
    n_max = max(int(np.shape(x)[0]) for x in xs)
    d = int(np.shape(xs[0])[-1])
    X = np.zeros((m, n_max, d))
    Y = np.zeros((m, n_max))
    mask = np.zeros((m, n_max))
    for i, (x, y) in enumerate(zip(xs, ys)):
        n = int(np.shape(x)[0])
        X[i, :n] = np.asarray(x, np.float64)
        Y[i, :n] = np.asarray(y, np.float64).reshape(-1)
        mask[i, :n] = 1.0
    X, Y, mask = (torch.as_tensor(a, dtype=dtype, device=device)
                  for a in (X, Y, mask))
    tr = fit_standardize(Y, mask, dim=-1)
    y_std = (Y - tr.mean[:, None]) / tr.std[:, None] * mask
    return TaskData(X=X, y=y_std, mask=mask, mean=tr.mean, std=tr.std)


def meta_fit_task_stack(data: TaskData, cfg: gp.GPConfig,
                        generator: Optional[torch.Generator] = None,
                        num_restarts: int = 5, num_steps: int = 60,
                        mll_method: str = "chol",
                        init_stack: Optional[gp.GPParams] = None,
                        route_blocked: bool = False,
                        sweep_variant: str = "select") -> SourceStack:
    """Fit all source GPs at once, tasks x restarts as one batch.

    ``data`` has a leading task axis T.  The restart stack is the warm start
    followed by ``num_restarts`` prior draws from ``generator``; pass
    ``init_stack`` (leaves with leading (T, num_restarts + 1) axes) to use
    given draws instead.  ``mll_method``, ``route_blocked`` and
    ``sweep_variant`` choose the objective's MLL route (``gp.mll``); on the
    inverse route a task whose cached factor comes out non-finite is fitted
    again on the Cholesky route (``refit_nonfinite_tasks``).
    """
    T, _, d = data.X.shape
    dtype, dev = data.X.dtype, data.X.device
    if init_stack is None:
        warm = gp.init_params(cfg, d, dtype, dev, batch_shape=(T,))
        sampled = fit_lib.tree_map(
            lambda leaf: leaf.to(dev),
            gp.sample_params(cfg, generator, d, dtype,
                             batch_shape=(T, num_restarts)))
        init_stack = fit_lib.stack_restarts(warm, sampled, batch_ndim=1)
    X, y, mask = data.X[:, None], data.y[:, None], data.mask[:, None]

    def objective(p):
        return gp.map_objective(cfg, p, X, y, mask, method=mll_method,
                                route_blocked=route_blocked,
                                sweep_variant=sweep_variant)

    res = fit_lib.fit_map_restarts(objective, init_stack, num_steps=num_steps,
                                   batch_ndim=1)
    stack = finalize_source_stack(data, cfg, res.params)
    if mll_method == "chol":
        return stack
    return refit_nonfinite_tasks(stack, cfg, init_stack, num_steps)


def refit_nonfinite_tasks(stack: SourceStack, cfg: gp.GPConfig, init_stack,
                          num_steps: int = 60) -> SourceStack:
    """Fit again, on the Cholesky route and from the same restarts
    ``init_stack`` (leaves with leading (T, R) axes), every task of
    ``stack`` (leading task axis T) whose cached factor or alpha is not
    finite; the other tasks are returned as they are.

    The inverse routes' float32 MLL can stay finite, and large, at
    hyperparameters where the system is not positive definite in float32
    (on an H100, the seed-0 Branin N_m=32 meta-fit stopped at a noise of
    4e-8, ``tests/test_torch_source_refit.py``).  The Cholesky in
    ``finalize_source_stack`` then fails, and the NaN factor makes every
    prediction of the task's study NaN, padded rows included.  The
    Cholesky route's objective is NaN at such points, so its fit ends
    where the factor exists.  The JAX package keeps the NaN factor."""
    bad = ~(torch.isfinite(stack.chol).flatten(1).all(-1)
            & torch.isfinite(stack.alpha).all(-1))
    if not bool(bad.any()):
        return stack
    with GLOBAL_TIMER("meta_fit_refit_chol", stack.chol.device):
        refit = meta_fit_task_stack(
            TaskData(*[leaf[bad] for leaf in stack.data]), cfg,
            num_steps=num_steps, mll_method="chol",
            init_stack=fit_lib.tree_map(lambda leaf: leaf[bad], init_stack))

    def put(full, part):
        full = full.clone()
        full[bad] = part
        return full

    return SourceStack(data=stack.data,
                       params=fit_lib.tree_map(put, stack.params,
                                               refit.params),
                       chol=put(stack.chol, refit.chol),
                       alpha=put(stack.alpha, refit.alpha))


def finalize_source_stack(data: TaskData, cfg: gp.GPConfig,
                          params: gp.GPParams) -> SourceStack:
    """Cache per-task Cholesky factors / alpha vectors for prediction."""
    c = gp.constrain(cfg, params)
    K = gp.gram(cfg, c, data.X)
    st = linalg.cholesky_factor(K, c.noise, data.y, data.mask)
    return SourceStack(data=data, params=params, chol=st.chol, alpha=st.alpha)


def _gram_diag(cfg: gp.GPConfig, c: gp.Constrained, x):
    """k(x_q, x_q) for each point of x (..., Q, d), computed like the
    reference's one-point Gram ``gram(cfg, c, xq)[0, 0]``."""
    cq = gp.Constrained(lengthscale=c.lengthscale.unsqueeze(-2),
                        outputscale=c.outputscale.unsqueeze(-1),
                        noise=c.noise)
    xq = x.unsqueeze(-2)
    return gp.gram(cfg, cq, xq)[..., 0, 0]


def source_predict(stack: SourceStack, cfg: gp.GPConfig, P,
                   full_cov: bool = True):
    """Per-task noise-free posterior at points P (..., q, d) in the ORIGINAL
    y space: means (..., M, q) and covs (..., M, q, q) or vars (..., M, q)."""
    d = stack.data
    c = gp.constrain(cfg, stack.params)
    Pm = P.unsqueeze(-3)
    Kxq = gp.gram(cfg, c, d.X, Pm) * d.mask[..., None]          # (..., M, N, q)
    mean = torch.sum(Kxq * stack.alpha[..., None], dim=-2)       # (..., M, q)
    v = linalg.solve_lower(stack.chol, Kxq)
    t_mean, t_std = d.mean[..., None], d.std[..., None]
    if full_cov:
        cov = gp.gram(cfg, c, Pm) - torch.matmul(v.transpose(-1, -2), v)
        return t_mean + t_std * mean, (t_std[..., None] ** 2) * cov
    var = torch.clamp_min(c.outputscale[..., None] - torch.sum(v * v, dim=-2),
                          0.0)
    return t_mean + t_std * mean, (t_std ** 2) * var


# ---------------------------------------------------------------------------
# Weight pruning
# ---------------------------------------------------------------------------

def significant_weights_mask(weights, std_Y_vals, threshold):
    r"""Mask of weights with ``w_i sigma_i * n_w / sum_j w_j sigma_j >= tau``."""
    num_weights = weights.shape[-1]
    w_sigma = weights * std_Y_vals
    norm = w_sigma * num_weights / torch.sum(w_sigma, dim=-1, keepdim=True)
    return norm >= threshold


# ---------------------------------------------------------------------------
# Target model
# ---------------------------------------------------------------------------

class TargetParams(NamedTuple):
    raw_weights: torch.Tensor  # (..., M) softplus-reparametrized task weights
    gp: gp.GPParams            # residual kernel + noise


def weights_forward(raw):
    """w = softplus(raw) + 1e-10: a smooth stand-in for the reference's
    unenforced GreaterThan(1e-10) bound, with the same prior."""
    return softplus(raw) + WEIGHTS_LOWER_BOUND


def weights_inverse(w):
    return inv_softplus(torch.clamp_min(w - WEIGHTS_LOWER_BOUND, 1e-30))


def init_target_params(cfg: gp.GPConfig, num_tasks: int, ard_dims: int,
                       dtype=torch.float32, device=None,
                       batch_shape=()) -> TargetParams:
    w0 = torch.full(tuple(batch_shape) + (num_tasks,), 1.0 / num_tasks,
                    dtype=dtype, device=device)
    return TargetParams(raw_weights=weights_inverse(w0),
                        gp=gp.init_params(cfg, ard_dims, dtype, device,
                                          batch_shape))


def sample_target_params(cfg: gp.GPConfig, generator: torch.Generator,
                         num_tasks: int, ard_dims: int, dtype=torch.float32,
                         batch_shape=()) -> TargetParams:
    """Prior draws with leading ``batch_shape``, on the generator's device."""
    batch_shape = tuple(batch_shape)
    w = WEIGHTS_PRIOR.sample(generator, batch_shape + (num_tasks,), dtype)
    w = torch.clamp_min(w, 1e-8)
    return TargetParams(raw_weights=weights_inverse(w),
                        gp=gp.sample_params(cfg, generator, ard_dims, dtype,
                                            batch_shape))


class AcqState(NamedTuple):
    """Candidate-independent cache for the acquisition: built once per refit,
    it turns each candidate into O(M Ns + n) work against cached factors."""

    st: linalg.CholState     # factorization of the standardized n x n system
    v1: torch.Tensor         # (..., M, Ns, n) per-source L^{-1} K(Xs, train_X)
    w_eff: torch.Tensor      # (..., M) pruned mixture weights
    c: gp.Constrained        # constrained target kernel + noise
    out_mean: torch.Tensor   # (...,) frozen global normalizer
    out_std: torch.Tensor    # (...,)


def acq_state_from_parts(stack: SourceStack, source_cfg: gp.GPConfig,
                         target_cfg: gp.GPConfig, params: TargetParams,
                         Xbuf, ybuf, mask, out_mean, out_std,
                         pruning_threshold: float) -> AcqState:
    """Build the cached acquisition state from explicit buffers; every
    argument may carry the same leading (study) axes."""
    w = weights_forward(params.raw_weights)
    prune = significant_weights_mask(
        w, stack.data.std, pruning_threshold).to(Xbuf.dtype)
    w_eff = w * prune
    c = gp.constrain(target_cfg, params.gp)

    means_n, covs_nn = source_predict(stack, source_cfg, Xbuf, full_cov=True)
    mean_p = torch.sum(means_n * w_eff[..., None], dim=-2)
    cov_p = torch.sum(covs_nn * (w_eff ** 2)[..., None, None], dim=-3)
    om, os_ = out_mean[..., None], out_std[..., None]
    mean_std_n = (mean_p - om) / os_
    cov_std = cov_p / (os_[..., None] ** 2)
    Kt_nn = gp.gram(target_cfg, c, Xbuf)
    y_std = (ybuf - om) / os_ * mask
    resid = y_std - mean_std_n * mask
    st = linalg.cholesky_factor(cov_std + Kt_nn, c.noise, resid, mask)

    cs = gp.constrain(source_cfg, stack.params)
    Kxn = gp.gram(source_cfg, cs, stack.data.X, Xbuf.unsqueeze(-3)) \
        * stack.data.mask[..., None]                           # (..., M, Ns, n)
    v1 = linalg.solve_lower(stack.chol, Kxn)
    return AcqState(st=st, v1=v1, w_eff=w_eff, c=c, out_mean=out_mean,
                    out_std=out_std)


def posterior_diag_from_state(stack: SourceStack, source_cfg: gp.GPConfig,
                              target_cfg: gp.GPConfig, state: AcqState,
                              Xbuf, Xq, original_scale: bool = True):
    """Marginal posterior (mean, var) at candidates Xq (..., Q, d) via the
    cached state — the joint-conditioning posterior, one candidate at a
    time, for all Q candidates at once."""
    st, v1, w_eff, c, out_mean, out_std = state
    d = stack.data
    cs = gp.constrain(source_cfg, stack.params)
    Xq_m = Xq.unsqueeze(-3)                                    # (..., 1, Q, d)
    Ksq = gp.gram(source_cfg, cs, d.X, Xq_m) * d.mask[..., None]  # (..., M, Ns, Q)
    mean_q = torch.sum(Ksq * stack.alpha[..., None], dim=-2)      # (..., M, Q)
    v2 = linalg.solve_lower(stack.chol, Ksq)                      # (..., M, Ns, Q)
    knq = gp.gram(source_cfg, cs, Xbuf.unsqueeze(-3), Xq_m)       # (..., M, n, Q)
    cross = knq - torch.matmul(v1.transpose(-1, -2), v2)
    qq = _gram_diag(source_cfg, cs, Xq_m) - torch.sum(v2 * v2, dim=-2)

    t_mean, t_std2 = d.mean[..., None], (d.std ** 2)[..., None]
    means_q = t_mean + d.std[..., None] * mean_q                 # (..., M, Q)
    om, os_ = out_mean[..., None], out_std[..., None]
    w2 = (w_eff ** 2)[..., None]
    mean_q_std = (torch.sum(w_eff[..., None] * means_q, dim=-2) - om) / os_
    cross_std = torch.sum(w2[..., None] * t_std2[..., None] * cross,
                          dim=-3) / (os_[..., None] ** 2)           # (..., n, Q)
    qq_std = torch.sum(w2 * t_std2 * qq, dim=-2) / os_ ** 2        # (..., Q)

    kt_nq = gp.gram(target_cfg, c, Xbuf, Xq)                      # (..., n, Q)
    kt_qq = _gram_diag(target_cfg, c, Xq)                         # (..., Q)
    mu, var = linalg.posterior(st, cross_std + kt_nq,
                               Kqq_diag=qq_std + kt_qq)
    mu = mu + mean_q_std
    var = torch.clamp_min(var, 1e-30)
    if original_scale:
        return mu * os_ + om, var * os_ ** 2
    return mu, var
