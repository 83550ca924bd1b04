"""Task-sharded ScaML-GP: meta-fit and target fit over the task slots of a
mesh (``scamlgp_tpu/parallel/scamlgp_sharded.py``).

The task axis is split over the task slots of the mesh's first local study
row (``Mesh.task_devices``).  Each slot runs the same batched fit as the
one-device path on its share of the tasks.  The cross-task quantities, the
global outcome normalizer and the weighted source mixture of the target
MLL, are the JAX package's ``psum`` reductions: each slot's partial is moved
to the first slot and the partials are summed there in slot order.
Autograd carries the target fit's gradients back through that sum to each
slot's own weight shard.  Slots on one device run one after another.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scamlgp_tpu_torch.bo.optimize import _B1, _B2, _EPS
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.parallel.mesh import Mesh, cat_rows, split_rows
from scamlgp_tpu_torch.utils.standardize import _MIN_STD


def pad_task_data(data: m.TaskData, multiple: int) -> m.TaskData:
    """Pad the task axis to a multiple of the mesh's task extent with fully
    masked dummy tasks (std=1, mean=0 so they are inert everywhere)."""
    M = data.X.shape[0]
    extra = (-M) % multiple
    if not extra:
        return data

    def pad(leaf, value):
        return torch.cat([leaf, leaf.new_full((extra,) + leaf.shape[1:],
                                              value)])

    return m.TaskData(X=pad(data.X, 0.0), y=pad(data.y, 0.0),
                      mask=pad(data.mask, 0.0), mean=pad(data.mean, 0.0),
                      std=pad(data.std, 1.0))


def meta_fit_sharded(data: m.TaskData, cfg: gp.GPConfig,
                     generator: Optional[torch.Generator], mesh: Mesh,
                     num_restarts: int = 5, num_steps: int = 60,
                     mll_method: str = "chol",
                     init_stack: Optional[gp.GPParams] = None
                     ) -> m.SourceStack:
    """Source-GP stack fit with the task axis split over the task slots.

    The task axis is padded to a multiple of the slots (``pad_task_data``)
    and the restart stack (the warm start, then ``num_restarts`` prior draws
    from ``generator``) is drawn once for every padded task, or given as
    ``init_stack`` with leading (padded T, num_restarts + 1) axes, and then
    split: a task's fit does not depend on the mesh.  Each slot runs
    ``meta_fit_task_stack`` on its tasks (no communication), its MLL on
    ``mll_method``'s route (``chol`` by default, as in the JAX package).
    Returns the padded stack on the first slot's device.
    """
    devices = mesh.task_devices()
    data = pad_task_data(data, len(devices))
    T, _, d = data.X.shape
    if init_stack is None:
        warm = gp.init_params(cfg, d, data.X.dtype, batch_shape=(T,))
        sampled = gp.sample_params(cfg, generator, d, data.X.dtype,
                                   batch_shape=(T, num_restarts))
        init_stack = fit_lib.stack_restarts(warm, sampled, batch_ndim=1)
    parts = [m.meta_fit_task_stack(local, cfg, num_steps=num_steps,
                                   mll_method=mll_method, init_stack=init)
             for local, init in zip(split_rows(data, devices),
                                    split_rows(init_stack, devices))]
    return cat_rows(parts, devices[0])


class ShardedTargetState(NamedTuple):
    """Target-model state with the source caches of every (padded) task."""

    cached_means: torch.Tensor   # (M, n) original-space source means at X
    cached_covs: torch.Tensor    # (M, n, n)
    source_std: torch.Tensor     # (M,) per-task Y stds (pruning + normalizer)
    source_mean: torch.Tensor    # (M,)
    source_mask_counts: torch.Tensor  # (M,) observation counts per task
    train_X: torch.Tensor
    train_y: torch.Tensor
    train_mask: torch.Tensor
    out_mean: torch.Tensor
    out_std: torch.Tensor


def _slot_sum(partials, device):
    """The partials of the slots summed on ``device`` in slot order (the
    JAX package's ``psum``)."""
    total = partials[0].to(device)
    for part in partials[1:]:
        total = total + part.to(device)
    return total


def build_sharded_target(source: m.SourceStack, source_cfg: gp.GPConfig,
                         train_X, train_y, train_mask, mesh: Mesh
                         ) -> ShardedTargetState:
    """Cache the source moments at train_X, each slot its tasks, and fit the
    global normalizer from the slots' summed partials.  The state lives on
    the first slot's device."""
    d = source.data
    means, covs, s1, s2, cnt = _cache_impl(source, source_cfg, train_X, mesh)
    home = means.device
    train_X, train_mask = train_X.to(home), train_mask.to(home)
    train_y = train_y.to(home).reshape(-1)
    n_t = torch.sum(train_mask)
    total = cnt + n_t
    s1t = s1 + torch.sum(train_y * train_mask)
    s2t = s2 + torch.sum((train_y * train_mask) ** 2)
    mean_all = s1t / torch.clamp_min(total, 1.0)
    var_all = (s2t - total * mean_all ** 2) / torch.clamp_min(total - 1.0,
                                                              1.0)
    std_all = torch.sqrt(torch.clamp_min(var_all, 0.0))
    std_all = torch.where((total <= 1.0) | (std_all < _MIN_STD),
                          torch.ones_like(std_all), std_all)
    out_mean = torch.where(n_t > 0, mean_all, torch.zeros_like(mean_all))
    out_std = torch.where(n_t > 0, std_all, torch.ones_like(std_all))
    return ShardedTargetState(
        cached_means=means, cached_covs=covs, source_std=d.std.to(home),
        source_mean=d.mean.to(home),
        source_mask_counts=torch.sum(d.mask, dim=-1).to(home),
        train_X=train_X, train_y=train_y, train_mask=train_mask,
        out_mean=out_mean, out_std=out_std)


def _cache_impl(source: m.SourceStack, source_cfg: gp.GPConfig, train_X,
                mesh: Mesh):
    """Each slot's source prediction at train_X, joined on the first slot,
    and the normalizer's sums over every task's observations."""
    devices = mesh.task_devices()
    home = devices[0]
    means, covs, s1, s2, cnt = [], [], [], [], []
    for local in split_rows(source, devices):
        mu, cov = m.source_predict(local, source_cfg,
                                   train_X.to(local.chol.device),
                                   full_cov=True)
        means.append(mu)
        covs.append(cov)
        ld = local.data
        y_orig = ld.y * ld.std[:, None] + ld.mean[:, None]
        s1.append(torch.sum(y_orig * ld.mask))
        s2.append(torch.sum((y_orig * ld.mask) ** 2))
        cnt.append(torch.sum(ld.mask))
    return (cat_rows(means, home), cat_rows(covs, home),
            _slot_sum(s1, home), _slot_sum(s2, home), _slot_sum(cnt, home))


def fit_target_sharded(state: ShardedTargetState, target_cfg: gp.GPConfig,
                       params: m.TargetParams, mesh: Mesh,
                       num_steps: int = 100,
                       learning_rate: float = 0.05) -> m.TargetParams:
    """MAP fit of (weights, residual kernel, noise) with the weights split
    over the task slots.

    The training-mode prior mean and covariance and the weights' log-prior
    are sums of the slots' weighted source moments (reference hot loop 4,
    ``model.py:359-363``); the gradient flows back through those sums to
    each slot's weight shard.  ``num_steps`` of Adam (``optax.adam``'s
    defaults) update every parameter; the residual kernel's and the noise's
    parameters, which every slot shares, live on the first slot.  Padded
    tasks (no observations) have weight 0.
    """
    devices = mesh.task_devices()
    home = devices[0]
    y_std = ((state.train_y - state.out_mean) / state.out_std
             * state.train_mask)
    task_valid = (state.source_mask_counts > 0).to(state.cached_means.dtype)
    shards = list(zip(*[split_rows(t, devices) for t in (
        state.cached_means, state.cached_covs, task_valid)]))
    raw_w = [w.detach().clone() for w in split_rows(params.raw_weights,
                                                    devices)]
    gpp = [leaf.detach().to(home).clone() for leaf in params.gp]

    def objective(raw_w, gp_leaves):
        mean, cov, extra = [], [], []
        for (means, covs, valid), rw in zip(shards, raw_w):
            w_all = m.weights_forward(rw)
            w = w_all * valid
            mean.append(torch.einsum("mq,m->q", means, w))
            cov.append(torch.einsum("mqp,m->qp", covs, w ** 2))
            extra.append(torch.sum(m.WEIGHTS_PRIOR.log_prob(w_all) * valid))
        prior_mean = (_slot_sum(mean, home) - state.out_mean) / state.out_std
        prior_cov = _slot_sum(cov, home) / state.out_std ** 2
        return gp.map_objective(
            target_cfg, gp.GPParams(*gp_leaves), state.train_X, y_std,
            mask=state.train_mask, prior_mean=prior_mean,
            prior_cov=prior_cov, extra_log_prior=_slot_sum(extra, home))

    leaves = raw_w + gpp
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    for t in range(1, num_steps + 1):
        xs = [p.requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            grads = torch.autograd.grad(
                objective(xs[:len(raw_w)], xs[len(raw_w):]), xs)
        c1, c2 = 1.0 - _B1 ** t, 1.0 - _B2 ** t
        new = []
        for j, (p, g) in enumerate(zip(leaves, grads)):
            mu[j] = (1.0 - _B1) * g + _B1 * mu[j]
            nu[j] = (1.0 - _B2) * g * g + _B2 * nu[j]
            step = (mu[j] / c1) / (torch.sqrt(nu[j] / c2) + _EPS)
            new.append(p.detach() + (-learning_rate) * step)
        leaves = new
    return m.TargetParams(
        raw_weights=cat_rows(leaves[:len(raw_w)], home),
        gp=gp.GPParams(*leaves[len(raw_w):]))
