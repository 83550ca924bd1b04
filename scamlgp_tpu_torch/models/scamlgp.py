"""ScaML-GP — hierarchical sum-of-GPs meta-model (``scamlgp_tpu/models/scamlgp.py``).

One independent source GP per meta-task; the target GP's prior is the
weighted source posterior

    mu_s(x)       = sum_i w_i mu_i(x)
    Sigma_s(x,x') = sum_i w_i^2 Sigma_i(x,x')

plus a residual target kernel; the weights are learned with the target MLL.

Source GPs are one batched stack: data padded to a common N with masks,
parameters with a leading task axis (and any leading study axes in front of
it).  Weight pruning is a multiplicative 0/1 mask.

The target model ``ScaMLGP`` is one study's immutable state (source stack,
target buffers padded with a mask, frozen global normalizer, parameters and
the source moments cached at the training inputs), as the sequential driver
``bo/optimizer.py::ScaMLGPBO`` holds it.  Where the reference maps a
function over restarts or query points with ``vmap``, the port writes the
axis out: restarts are the leading axis of the parameters, query points a
leading axis of the inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scamlgp_tpu_torch.config import resolve_device
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


def validate_meta_data(xs, ys) -> None:
    """Shape checks of per-task meta-data (the reference's ``utils.py:112-136``,
    ``scamlgp_tpu/models/scamlgp.py:95``)."""
    if len(xs) == 0:
        raise ValueError("Empty meta data. Needs at least one source task.")
    if len(xs) != len(ys):
        raise ValueError("meta X and Y task counts differ.")
    d = np.shape(xs[0])[-1]
    for i, (x, y) in enumerate(zip(xs, ys)):
        if np.shape(x)[-1] != d:
            raise ValueError(f"Feature dim of task {i} does not match task 0.")
        y_shape = np.shape(y)
        if len(y_shape) == 2 and y_shape[-1] != 1:
            raise ValueError(
                f"The output dimension of task {i} is {y_shape[-1]} "
                f"but must be one")
        if np.shape(x)[0] != y_shape[0]:
            raise ValueError(f"X/Y length mismatch in task {i}.")


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
    ``sweep_variant`` choose the objective's MLL route (``gp.mll``).  On
    every route but ``chol`` a task whose cached factor comes out
    non-finite is fitted again on the Cholesky route in the data's dtype
    (``refit_nonfinite_tasks``).  That includes ``chol64``: its float64
    objective stays finite where the cached factor, taken in the data's
    dtype, fails; only the ``chol`` objective is non-finite exactly where
    that factor is.
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


def output_normalizer(stack: SourceStack, ybuf, mask):
    """The frozen global Standardize over concat(meta-Y, target-Y) in the
    original space, with the identity where there is no target data
    (``model.py:261-276,307-308``).  ``ybuf``, ``mask`` (..., n) may carry
    leading (study) axes that the stack shares; returns (out_mean,
    out_std), each (...)."""
    d = stack.data
    meta_y = d.y * d.std[..., None] + d.mean[..., None]
    lead = meta_y.shape[:-2]
    all_y = torch.cat([meta_y.reshape(lead + (-1,)), ybuf], dim=-1)
    all_m = torch.cat([d.mask.reshape(lead + (-1,)), mask], dim=-1)
    tr = fit_standardize(all_y, all_m, dim=-1)
    has_target = torch.sum(mask, dim=-1) > 0
    out_mean = torch.where(has_target, tr.mean, torch.zeros_like(tr.mean))
    out_std = torch.where(has_target, tr.std, torch.ones_like(tr.std))
    return out_mean, out_std


class ScaMLGP(NamedTuple):
    """Immutable model state of one study: source stack + target data +
    parameters (the reference's ``ScaMLGP(SingleTaskGP)``,
    ``model.py:218-384``).  ``train_y`` is in the original space; the
    frozen global normalizer is ``(out_mean, out_std)``."""

    source: SourceStack
    train_X: torch.Tensor              # (n, d)
    train_y: torch.Tensor              # (n,) original space
    train_mask: torch.Tensor           # (n,)
    out_mean: torch.Tensor             # ()
    out_std: torch.Tensor              # ()
    params: TargetParams
    cached_source_means: torch.Tensor  # (n, M) original space at train_X
    cached_source_covs: torch.Tensor   # (M, n, n)

    @property
    def weights(self):
        return weights_forward(self.params.raw_weights)

    @property
    def num_tasks(self) -> int:
        return self.source.num_tasks


def build_scamlgp(source: SourceStack, source_cfg: gp.GPConfig,
                  train_X, train_y, train_mask=None,
                  target_cfg: Optional[gp.GPConfig] = None,
                  params: Optional[TargetParams] = None) -> ScaMLGP:
    """Assemble the target model (``model.py:218-339``): fit and freeze the
    global normalizer on concat(meta-Y, target-Y), cache the source moments
    at train_X, and start the weights at 1/M (or take ``params`` as the
    warm start)."""
    target_cfg = target_cfg or gp.target_gp_config()
    train_y = train_y.reshape(-1)
    n, d = train_X.shape
    if train_mask is None:
        train_mask = torch.ones((n,), dtype=train_X.dtype,
                                device=train_X.device)
    out_mean, out_std = output_normalizer(source, train_y, train_mask)
    means, covs = source_predict(source, source_cfg, train_X, full_cov=True)
    if params is None:
        params = init_target_params(target_cfg, source.num_tasks, d,
                                    train_X.dtype, train_X.device)
    return ScaMLGP(source=source, train_X=train_X, train_y=train_y,
                   train_mask=train_mask, out_mean=out_mean.to(train_X.dtype),
                   out_std=out_std.to(train_X.dtype), params=params,
                   cached_source_means=means.transpose(-1, -2),
                   cached_source_covs=covs)


def _training_prior(model: ScaMLGP, params: TargetParams):
    """Training-mode prior moments at train_X from the cached source
    posteriors, through the frozen normalizer (``model.py:359-363,376-382``).
    ``params`` may carry leading (restart) axes: (..., n), (..., n, n)."""
    w = weights_forward(params.raw_weights)                     # (..., M)
    mean = torch.einsum("nm,...m->...n", model.cached_source_means, w)
    cov = torch.einsum("mij,...m->...ij", model.cached_source_covs, w ** 2)
    return ((mean - model.out_mean) / model.out_std,
            cov / model.out_std ** 2)


def scamlgp_map_objective(model: ScaMLGP, target_cfg: gp.GPConfig,
                          params: TargetParams) -> torch.Tensor:
    """Negative (target MLL + priors), one value per leading (restart)
    index of ``params`` (``model.py:359-363`` + ``utils.py:175-192``)."""
    prior_mean, prior_cov = _training_prior(model, params)
    y_std = (model.train_y - model.out_mean) / model.out_std * model.train_mask
    w = weights_forward(params.raw_weights)
    extra = torch.sum(WEIGHTS_PRIOR.log_prob(w), dim=-1)
    return gp.map_objective(target_cfg, params.gp, model.train_X, y_std,
                            mask=model.train_mask, prior_mean=prior_mean,
                            prior_cov=prior_cov, extra_log_prior=extra)


def fit_scamlgp(model: ScaMLGP, target_cfg: gp.GPConfig,
                generator: Optional[torch.Generator] = None,
                num_restarts: int = 5, num_steps: int = 60,
                init_stack: Optional[TargetParams] = None) -> ScaMLGP:
    """Refit weights + residual kernel + noise from the warm start
    ``model.params`` and ``num_restarts`` prior draws from ``generator``
    (``optimizer.py:185`` -> ``utils.py:139-212``), all restarts as one
    batched L-BFGS.  ``init_stack`` (leaves with a leading restart axis,
    the warm start first) replaces the warm start and the draws."""
    if init_stack is None:
        dev = model.train_X.device
        sampled = sample_target_params(
            target_cfg, generator, model.num_tasks, model.train_X.shape[-1],
            model.train_X.dtype, batch_shape=(num_restarts,))
        init_stack = fit_lib.stack_restarts(
            model.params, fit_lib.tree_map(lambda leaf: leaf.to(dev),
                                           sampled))
    res = fit_lib.fit_map_restarts(
        lambda p: scamlgp_map_objective(model, target_cfg, p), init_stack,
        num_steps=num_steps)
    return model._replace(params=res.params)


def _eval_prior(model: ScaMLGP, source_cfg: gp.GPConfig, P,
                pruning_threshold: float = DEFAULT_PRUNING_THRESHOLD):
    """Eval-mode prior over points P (..., q, d) in standardized target
    space, with weight pruning (``model.py:364-382``)."""
    w = weights_forward(model.params.raw_weights)
    prune = significant_weights_mask(
        w, model.source.data.std, pruning_threshold).to(P.dtype)
    means, covs = source_predict(model.source, source_cfg, P, full_cov=True)
    w_eff = w * prune
    mean = torch.sum(means * w_eff[..., None], dim=-2)
    cov = torch.sum(covs * (w_eff ** 2)[..., None, None], dim=-3)
    return ((mean - model.out_mean) / model.out_std,
            cov / model.out_std ** 2)


def scamlgp_posterior(model: ScaMLGP, source_cfg: gp.GPConfig,
                      target_cfg: gp.GPConfig, Xq,
                      pruning_threshold: float = DEFAULT_PRUNING_THRESHOLD,
                      observation_noise: bool = False,
                      original_scale: bool = True):
    """Posterior predictive (mean (..., q), cov (..., q, q)) at Xq
    (..., q, d) by joint conditioning: the prior over [train_X; Xq] from the
    pruned source mixture plus the residual kernel, conditioned exactly on
    the standardized target observations; in the original y space when
    ``original_scale``.  Leading axes of Xq are independent queries."""
    n = model.train_X.shape[0]
    lead = Xq.shape[:-2]
    P = torch.cat([model.train_X.expand(lead + model.train_X.shape), Xq],
                  dim=-2)
    prior_mean, prior_cov = _eval_prior(model, source_cfg, P,
                                        pruning_threshold)
    c = gp.constrain(target_cfg, model.params.gp)
    cov_full = prior_cov + gp.gram(target_cfg, c, P)
    mask = model.train_mask
    y_std = (model.train_y - model.out_mean) / model.out_std * mask
    resid = y_std - prior_mean[..., :n] * mask
    state = linalg.cholesky_factor(cov_full[..., :n, :n], c.noise, resid,
                                   mask)
    mean, cov = linalg.posterior(state, cov_full[..., :n, n:],
                                 Kqq=cov_full[..., n:, n:])
    mean = mean + prior_mean[..., n:]
    if observation_noise:
        cov = cov + c.noise * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                        device=cov.device)
    if original_scale:
        mean = mean * model.out_std + model.out_mean
        cov = cov * model.out_std ** 2
    return mean, cov


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


def scamlgp_acq_state(model: ScaMLGP, source_cfg: gp.GPConfig,
                      target_cfg: gp.GPConfig,
                      pruning_threshold: float = DEFAULT_PRUNING_THRESHOLD,
                      params: Optional[TargetParams] = None) -> AcqState:
    """Cached acquisition state of a fitted model, built once per refit
    (``params`` overrides the model's)."""
    p = model.params if params is None else params
    return acq_state_from_parts(
        model.source, source_cfg, target_cfg, p, model.train_X,
        model.train_y, model.train_mask, model.out_mean, model.out_std,
        pruning_threshold)


def scamlgp_posterior_diag_cached(model: ScaMLGP, source_cfg: gp.GPConfig,
                                  target_cfg: gp.GPConfig, state: AcqState,
                                  Xq, original_scale: bool = True):
    """Marginal (mean, var) at Xq (Q, d) through the cached state: the
    result of ``scamlgp_posterior_diag`` at O(n) work per candidate."""
    return posterior_diag_from_state(model.source, source_cfg, target_cfg,
                                     state, model.train_X, Xq,
                                     original_scale=original_scale)


def scamlgp_posterior_diag(model: ScaMLGP, source_cfg: gp.GPConfig,
                           target_cfg: gp.GPConfig, Xq,
                           pruning_threshold: float = DEFAULT_PRUNING_THRESHOLD,
                           original_scale: bool = True):
    """Marginal mean and variance at each point of Xq (Q, d), each point
    conditioned jointly on its own (n+1)-point model, all Q at once.  The
    model's parameters may carry leading axes that broadcast against (Q,),
    such as (K, 1) for K parameter draws: the result then has theirs."""
    mean, cov = scamlgp_posterior(model, source_cfg, target_cfg,
                                  Xq[:, None, :],
                                  pruning_threshold=pruning_threshold,
                                  original_scale=original_scale)
    return mean[..., 0], torch.clamp_min(cov[..., 0, 0], 1e-30)


def meta_fit_scamlgp(meta_xs, meta_ys,
                     generator: Optional[torch.Generator] = None,
                     cfg: Optional[gp.GPConfig] = None,
                     num_restarts_log_likelihood: int = 5,
                     num_steps: int = 60, dtype=torch.float64, device=None,
                     init_stack: Optional[gp.GPParams] = None):
    """Fit the source GP stack on per-task meta-data (the reference's
    ``meta_fit_scamlgp``, ``model.py:138-189``) on the Cholesky route, as
    the JAX package does.

    Args:
        meta_xs / meta_ys: per-task (N_i, d) unit-cube inputs and (N_i,) or
            (N_i, 1) observations.
        generator: source of the restart draws (a CPU generator seeded with
            0 when left out); ``init_stack`` replaces them
            (``meta_fit_task_stack``).
        device: ``cuda`` unless the caller names one.
    Returns:
        (fitted SourceStack, the GPConfig used).
    """
    validate_meta_data(meta_xs, meta_ys)
    cfg = cfg or gp.source_gp_config()
    if generator is None and init_stack is None:
        generator = torch.Generator(device="cpu").manual_seed(0)
    data = pack_task_data(meta_xs, meta_ys, dtype=dtype,
                          device=resolve_device(device))
    stack = meta_fit_task_stack(data, cfg, generator,
                                num_restarts=num_restarts_log_likelihood,
                                num_steps=num_steps, mll_method="chol",
                                init_stack=init_stack)
    return stack, cfg
