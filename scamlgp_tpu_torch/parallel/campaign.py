"""Lock-step BO campaigns: studies as a batch axis
(``scamlgp_tpu/parallel/campaign.py``, host loop).

One call runs S studies of a synthetic benchmark side by side: the meta-fit
of all S x M source GPs as one batch, then per iteration the target fits of
all S studies, the UCB acquisition ascent of all S studies x starts as one
batched Adam, and the benchmark evaluation.  The host loops over iterations
only; with ``study_chunk`` it runs the iterations of one chunk of studies
after another.

With ``loop="device"`` (the JAX package's ``fori_loop`` campaign) no
iteration syncs with the host: every iteration's draws are made first and
put on the device along an iteration axis, and one body
(``device_iteration``) reads its draws and writes its buffers at an
iteration index held in a device tensor.  Its target fit takes the
fixed-trip L-BFGS and NUTS (``fixed_trips``), which give the host loop's
bits.  On a CUDA device iteration 0 runs eagerly, as the warm-up, and the
body is then captured once as a CUDA graph and replayed for every later
iteration; on the CPU the body runs eagerly for every iteration.

With a ``mesh`` (``parallel/mesh.py``) the studies are split over its
study rows, padded to a multiple of them with copies of study 0: each row
of this process runs its studies' meta-fit and iterations on the row's
first slot, the rows of this process in lock-step, iteration by
iteration, one after another or, on a mesh with ``at_once``, at once
(``run_slots``: a host thread and a CUDA stream a row), and on a mesh over
several processes (``parallel/distributed.py``) a process runs its own
rows only.  Study chunks (``study_chunk``) and
meta-fit chunks still run one after another: they bound memory.

The target fit is ``CampaignConfig.fit_method``'s: ``"map"``, the MAP fits
of all S studies x restarts as one batched L-BFGS; ``"hmc"`` or
``"nuts"``, the posterior draws of all S studies x chains as one batch of
chains (``models/hmc.py``); ``"vi"``, mean-field ADVI of all S studies,
their S x ``vi_mc`` Monte-Carlo draws one log-density call a step
(``models/vi.py``).  A posterior fit's acquisition moment-matches the
mixture of ``mixture_samples`` draws a study, then applies UCB once.

With ``mll_method="sweep"`` every fit objective with N <= 128 goes through
the hand-written sweep kernel of step scheme ``sweep_variant``
(``ops/sweep.py``) with the analytic gradient of ``ops/inverse_mll.py``;
with ``route_blocked`` as well, every one with 192 <= N <= 1024 (the
meta-fit of the points-per-task ablations) goes through the
blocked-Cholesky kernels (``ops/blocked_chol.py``).  ``mll_method="chol64"``
assembles and factors every fit objective's system in float64
(``gp.mll``).

The stages are timed in ``utils.profiling.GLOBAL_TIMER`` under the
reference's names (``campaign_stage_inputs``, ``campaign_meta_fit``,
``campaign_bo_loop``, ``campaign_iteration``) and, within an iteration,
``iteration_draws``, ``iteration_fit_target`` (a MAP fit) or
``iteration_sample_target`` (a posterior fit), ``iteration_acq_state``,
``iteration_propose`` and ``iteration_benchmark``; checkpoint writes are
``campaign_checkpoint``.  Each stage synchronizes its thread's stream
before its clock is read; the ``iteration_*`` stages are each row's own
(``utils.profiling.Timer``).  The device loop times no stage within a
captured iteration.

Randomness comes from host ``torch.Generator`` s; their draws move to the
device.  The meta-fit's restarts come from one generator seeded with
``seed``.  Iteration i's draws, for all S studies at once, come from
``iteration_generator(seed, i)``, seeded from ``(seed, i)`` alone: a study
chunk takes its rows of the full draw, so chunking does not change what a
study sees, and a resumed campaign needs no generator state.
``iteration_draws`` makes one iteration's draws (a posterior fit's chain
starts and sampler draws among them) and ``run_iteration`` takes them as
arguments, so tests can hand the JAX package and the port the same draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from scamlgp_tpu_torch.bo.acquisition import UpperConfidenceBound
from scamlgp_tpu_torch.bo.optimize import ascend, top_starts
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import hmc as hmc_lib
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.models import vi as vi_lib
from scamlgp_tpu_torch.ops import inverse_mll
from scamlgp_tpu_torch.parallel.mesh import (
    Mesh,
    cat_rows,
    pad_to_multiple,
    run_slots,
)
from scamlgp_tpu_torch.utils import checkpoint as ckpt
from scamlgp_tpu_torch.utils import cuda_graph
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


FIT_METHODS = ("map", "hmc", "nuts", "vi")


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    n_evaluations: int = 40
    noise_std: float = 1.0
    ucb_beta: float = 9.0                  # utils.py:215-224
    fit_method: str = "map"                # "map" | "hmc" | "nuts" | "vi"
    fit_steps: int = 60                    # L-BFGS iterations per restart
    fit_restarts: int = 5                  # prior-sampled, on top of warm
    acq_raw_samples: int = 256
    acq_topk: int = 4
    acq_steps: int = 30
    acq_lr: float = 0.05
    mll_method: str = "chol"               # "chol" | "sweep" | "chol64"
    route_blocked: bool = False            # sweep: blocked kernel, mid N
    sweep_variant: str = "select"          # sweep: step scheme, N <= 128
    pruning_threshold: float = 1e-3        # model.py:226
    # fit_method in {"hmc", "nuts"}: the posterior of every refit; the
    # acquisition marginalizes over `mixture_samples` draws
    hmc_chains: int = 2
    hmc_warmup: int = 64
    hmc_samples: int = 16
    hmc_leapfrog: int = 12                 # hmc only
    hmc_max_depth: int = 6                 # nuts only
    mixture_samples: int = 8
    # fit_method == "vi": mean-field ADVI; the mixture's draws come from q
    vi_steps: int = 200
    vi_mc: int = 8
    vi_lr: float = 0.05

    def __post_init__(self):
        if self.fit_method not in FIT_METHODS:
            raise ValueError(f"Unknown fit_method {self.fit_method!r} "
                             f"({' | '.join(FIT_METHODS)})")


class CampaignResult(NamedTuple):
    X: torch.Tensor        # (S, E, d) proposed unit-cube configs
    y: torch.Tensor        # (S, E) noisy observed losses
    y_clean: torch.Tensor  # (S, E) noise-free losses
    meta_fit_seconds: float
    iteration_seconds: list  # host clock per BO iteration run, device
    #                          synced (chunk after chunk in a chunked run);
    #                          the device loop on a card: CUDA event time of
    #                          the warm-up, then of each replay
    launches: dict           # kernel name -> launches in the meta-fit, then
    #                          in each iteration run (all 0 where no CUDA
    #                          tensor ran); a replay's are those counted
    #                          while its graph was captured
    nonfinite_source_tasks: int  # fitted source GPs whose cached factor
    #                              or alpha is not finite after the
    #                              meta-fit's Cholesky-route refit (their
    #                              study's predictions are then not finite)
    mask: torch.Tensor     # (S, E) 1 where the evaluation is filled: all
    #                        1 unless ``stop_after`` ended the run early or
    #                        another process holds the study
    samples: Optional[m.TargetParams] = None  # a posterior fit's mixture
    #                        draws (S, mixture_samples, ...) of the last
    #                        iteration this call ran (NaN for studies it
    #                        ran none of)
    stack: Optional[m.SourceStack] = None     # the fitted source GPs of
    #                        the studies held (all S but on a mesh over
    #                        several processes), in ``studies``' order
    studies: Optional[torch.Tensor] = None    # the studies whose rows this
    #                        call ran (all S but on a mesh over several
    #                        processes)
    graph: Optional[dict] = None  # the device loop on a card: each row's
    #                        capture and instantiate seconds, its graph's
    #                        kernel nodes, and the device memory around
    #                        them (``_device_loop``)


class CampaignState(NamedTuple):
    """What a campaign checkpoint holds: the target tasks and meta-data
    (target tasks are drawn unseeded, so a fresh process would otherwise
    resume against other targets), the buffers, the fitted target
    parameters, the seed, and the iterations every study has completed
    (informational: progress is read from ``mask``)."""

    task_params: dict
    meta_data: m.TaskData
    X: torch.Tensor
    y: torch.Tensor
    y_clean: torch.Tensor
    mask: torch.Tensor
    params: m.TargetParams
    seed: torch.Tensor        # () int64
    completed: torch.Tensor   # () int64


class IterationDraws(NamedTuple):
    """The random inputs of one lock-step iteration, study axis first."""

    restarts: Optional[m.TargetParams]  # map: (S, fit_restarts, ...) prior
    #                                     draws
    raw: torch.Tensor          # (S, acq_raw_samples, d) uniform candidates
    noise: torch.Tensor        # (S,) standard normal observation noise
    chains: Optional[m.TargetParams] = None  # hmc, nuts: (S, hmc_chains,
    #                                          ...) prior-drawn chain starts
    sampler: Optional[tuple] = None  # hmc: HMCDraws, nuts: NUTSDraws, each
    #                                  (S, hmc_chains, T, ...); vi: VIDraws
    #                                  (S, ...)


def iteration_generator(seed: int, i: int) -> torch.Generator:
    """Iteration ``i``'s host generator, seeded with
    ``numpy.random.SeedSequence([seed, i]).generate_state(1, uint64)[0]``."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    return torch.Generator(device="cpu").manual_seed(int(state[0]))


def _rows(tree, c0: int, c1: int):
    """Rows c0:c1 of every leaf (the study axis) of a NamedTuple tree;
    absent (None) members stay absent."""
    return fit_lib.tree_map(
        lambda leaf: None if leaf is None else leaf[c0:c1], tree)


def _pad_rows(tree, pad: int):
    """Every leaf (the study axis first) with ``pad`` copies of its row 0
    appended; absent (None) members stay absent."""
    if not pad:
        return tree
    return fit_lib.tree_map(
        lambda leaf: None if leaf is None else torch.cat(
            [leaf, leaf[:1].expand((pad,) + leaf.shape[1:])]), tree)


def _to(tree, device):
    """Every leaf of a NamedTuple tree on ``device``."""
    return fit_lib.tree_map(
        lambda leaf: None if leaf is None else leaf.to(device), tree)


def iteration_draws(generator: torch.Generator, cfg: CampaignConfig,
                    target_cfg: gp.GPConfig, S: int, M: int, d: int,
                    dtype, device) -> IterationDraws:
    """One iteration's draws for all S studies, in this order: the target
    fit's (a MAP fit's restarts; the chain starts, then the HMC or NUTS
    draws; the ADVI draws), the raw candidates, the noise."""
    restarts = chains = sampler = None
    D = M + d + 2
    if cfg.fit_method == "map":
        restarts = _to(m.sample_target_params(
            target_cfg, generator, M, d, dtype,
            batch_shape=(S, cfg.fit_restarts)), device)
    elif cfg.fit_method in ("hmc", "nuts"):
        batch = (S, cfg.hmc_chains)
        T = cfg.hmc_warmup + cfg.hmc_samples
        chains = _to(m.sample_target_params(target_cfg, generator, M, d,
                                            dtype, batch_shape=batch), device)
        sampler = (hmc_lib.nuts_draws(generator, batch, T, D,
                                      cfg.hmc_max_depth, dtype, device)
                   if cfg.fit_method == "nuts" else
                   hmc_lib.hmc_draws(generator, batch, T, D, dtype, device))
    else:
        sampler = vi_lib.vi_draws(generator, (S,), cfg.vi_steps, cfg.vi_mc,
                                  cfg.mixture_samples, D, dtype, device)
    raw = torch.rand((S, cfg.acq_raw_samples, d), generator=generator,
                     dtype=dtype, device=generator.device)
    noise = torch.randn((S,), generator=generator, dtype=dtype,
                        device=generator.device)
    return IterationDraws(restarts=restarts, raw=raw.to(device),
                          noise=noise.to(device), chains=chains,
                          sampler=sampler)


def _study_acq_state(stack, source_cfg, target_cfg, params, Xbuf, ybuf, mask,
                     out_mean, out_std, pruning_threshold):
    """Candidate-independent acquisition cache, batched over studies — see
    ``models.scamlgp.acq_state_from_parts``."""
    return m.acq_state_from_parts(stack, source_cfg, target_cfg, params,
                                  Xbuf, ybuf, mask, out_mean, out_std,
                                  pruning_threshold)


def _study_posterior_diag_fast(stack, source_cfg, target_cfg, acq_state,
                               Xbuf, Xq):
    """Marginal posterior at candidates Xq (S, Q, d) via the cached state."""
    return m.posterior_diag_from_state(stack, source_cfg, target_cfg,
                                       acq_state, Xbuf, Xq)


def target_objective(stack, source_cfg, target_cfg, Xbuf, ybuf, mask,
                     out_mean, out_std, cfg: CampaignConfig) -> Callable:
    """The training-mode MAP objective of every study's target parameters
    (cached source moments), a function of parameters with leading
    (..., R) axes, R restarts, chains or Monte-Carlo draws a study, to
    values (..., R).  Its MLL takes ``cfg``'s route (``mll_method``,
    ``route_blocked``, ``sweep_variant``)."""
    means, covs = m.source_predict(stack, source_cfg, Xbuf, full_cov=True)
    om, os_ = out_mean[..., None], out_std[..., None]
    y_std = (ybuf - om) / os_ * mask
    # one axis for the restarts, in front of the data's last axes
    Xr, yr, maskr = Xbuf.unsqueeze(-3), y_std.unsqueeze(-2), mask.unsqueeze(-2)
    omr, osr = om[..., None], os_[..., None]

    def objective(p):
        w = m.weights_forward(p.raw_weights)                    # (..., R, M)
        mean_p = (torch.einsum("...mq,...rm->...rq", means, w) - omr) / osr
        cov_p = torch.einsum("...mqp,...rm->...rqp", covs, w ** 2) / (
            osr[..., None] ** 2)
        extra = torch.sum(m.WEIGHTS_PRIOR.log_prob(w), dim=-1)
        return gp.map_objective(target_cfg, p.gp, Xr, yr, mask=maskr,
                                prior_mean=mean_p, prior_cov=cov_p,
                                extra_log_prior=extra,
                                method=cfg.mll_method,
                                route_blocked=cfg.route_blocked,
                                sweep_variant=cfg.sweep_variant)

    return objective


def _fit_target(stack, source_cfg, target_cfg, params_warm, Xbuf, ybuf, mask,
                out_mean, out_std, restarts: m.TargetParams,
                cfg: CampaignConfig,
                fixed_trips: bool = False) -> m.TargetParams:
    """Warm + prior-restart L-BFGS MAP fit of the target parameters of every
    study (training-mode cached source moments).  ``restarts`` carries the
    prior draws with leading (..., fit_restarts) axes; ``fixed_trips``
    runs every line search to its cap with no host sync."""
    objective = target_objective(stack, source_cfg, target_cfg, Xbuf, ybuf,
                                 mask, out_mean, out_std, cfg)
    batch_ndim = out_mean.ndim
    stack0 = fit_lib.stack_restarts(params_warm, restarts, batch_ndim)
    return fit_lib.fit_map_restarts(objective, stack0, num_steps=cfg.fit_steps,
                                    batch_ndim=batch_ndim,
                                    fixed_trips=fixed_trips).params


def _sample_target_hmc(stack, source_cfg, target_cfg, Xbuf, ybuf, mask,
                       out_mean, out_std, draws: IterationDraws,
                       cfg: CampaignConfig,
                       fixed_trips: bool = False) -> m.TargetParams:
    """Posterior draws of the target parameters of every study by HMC or
    NUTS chains (``cfg.fit_method``), all S x ``hmc_chains`` chains one
    batch, from ``draws.chains``' prior-drawn starts, over the objective of
    ``_fit_target``.  Returns draws (S, mixture_samples, ...): the chains
    interleaved sample-major and thinned from the tail.  ``fixed_trips``
    runs every NUTS transition to its cap with no host sync (HMC's
    trajectories are fixed already)."""
    objective = target_objective(stack, source_cfg, target_cfg, Xbuf, ybuf,
                                 mask, out_mean, out_std, cfg)
    sampler = hmc_lib.nuts if cfg.fit_method == "nuts" else hmc_lib.hmc
    extra = ({"max_depth": cfg.hmc_max_depth, "fixed_trips": fixed_trips}
             if cfg.fit_method == "nuts"
             else {"num_leapfrog": cfg.hmc_leapfrog})
    samples, _ = sampler(lambda p: -objective(p), draws.chains,
                         draws.sampler, num_warmup=cfg.hmc_warmup,
                         num_samples=cfg.hmc_samples, batch_ndim=2, **extra)
    return hmc_lib.interleave_and_thin(samples, cfg.mixture_samples,
                                       batch_ndim=1)


def _sample_target_vi(stack, source_cfg, target_cfg, params_warm, Xbuf, ybuf,
                      mask, out_mean, out_std, draws: IterationDraws,
                      cfg: CampaignConfig) -> m.TargetParams:
    """Posterior draws of the target parameters of every study by mean-field
    ADVI from ``params_warm``, over the objective of ``_fit_target``; each
    step evaluates all S x ``vi_mc`` draws at once.  Returns draws
    (S, mixture_samples, ...) from each study's q."""
    objective = target_objective(stack, source_cfg, target_cfg, Xbuf, ybuf,
                                 mask, out_mean, out_std, cfg)
    q, unflatten, _ = vi_lib.advi(lambda p: -objective(p), params_warm,
                                  draws.sampler.eps, lr=cfg.vi_lr,
                                  batch_ndim=1)
    return vi_lib.sample_q(q, unflatten, draws.sampler.sample)


def _with_draw_axis(stack, Xbuf, ybuf, mask, out_mean, out_std):
    """The study's arguments of the acquisition state with a unit axis after
    the study axis, against which a posterior fit's draws (S, K) broadcast:
    what does not depend on the draw is computed once a study."""
    return (fit_lib.tree_map(lambda leaf: leaf.unsqueeze(1), stack),
            Xbuf.unsqueeze(1), ybuf.unsqueeze(1), mask.unsqueeze(1),
            out_mean.unsqueeze(1), out_std.unsqueeze(1))


def _acquisition(stack, source_cfg, target_cfg, state, Xbuf,
                 cfg: CampaignConfig, mixture: bool = False) -> Callable:
    """UCB(beta, minimize) of every study at candidates x (S, Q, d), to
    values (S, Q).  With ``mixture``, ``state`` holds a posterior fit's
    draws on its second axis (``stack`` and ``Xbuf`` with the unit axis of
    ``_with_draw_axis``): each candidate's predictive is the draws'
    moment-matched mixture (the sequential driver's
    ``_acq_value_mixture``)."""
    ucb = UpperConfidenceBound(beta=cfg.ucb_beta)

    def acq(x):
        if mixture:
            mus, vars_ = _study_posterior_diag_fast(
                stack, source_cfg, target_cfg, state, Xbuf, x.unsqueeze(1))
            mu, var = hmc_lib.mixture_moments(mus, vars_, dim=1)
        else:
            mu, var = _study_posterior_diag_fast(
                stack, source_cfg, target_cfg, state, Xbuf, x)
        return ucb(mu, var)

    return acq


def _propose(stack, source_cfg, target_cfg, state, Xbuf, raw,
             cfg: CampaignConfig, mixture: bool = False) -> torch.Tensor:
    """Ascent of ``_acquisition`` over the unit cube for every study: the
    raw sweep picks the top-k starts, then Adam ascends from each."""
    acq = _acquisition(stack, source_cfg, target_cfg, state, Xbuf, cfg,
                       mixture)
    starts = top_starts(acq, raw, cfg.acq_topk)
    zs, negv = ascend(lambda x: -acq(x), starts, cfg.acq_steps, cfg.acq_lr)
    best = torch.argmin(torch.where(torch.isfinite(negv), negv, torch.inf),
                        dim=-1)
    z = torch.gather(zs, -2, best[..., None, None].expand(
        best.shape + (1, zs.shape[-1]))).squeeze(-2)
    return torch.sigmoid(z)


def _refit_and_propose(benchmark_fn: Callable, stack: m.SourceStack,
                       task_params, Xbuf, ybuf, mask, params: m.TargetParams,
                       draws: IterationDraws, source_cfg: gp.GPConfig,
                       target_cfg: gp.GPConfig, cfg: CampaignConfig,
                       fixed_trips: bool):
    """One lock-step iteration of every study up to the evaluation, its
    stages timed by ``GLOBAL_TIMER`` (which neither syncs nor records
    under a CUDA graph capture).  Returns (proposals (S, d), noise-free and
    noisy losses (S,), the parameters carried into the next iteration,
    a posterior fit's mixture draws or None)."""
    S, M = stack.data.X.shape[:2]
    dtype, dev = Xbuf.dtype, Xbuf.device
    args = (stack, source_cfg, target_cfg)
    samples = None
    mixture = cfg.fit_method != "map"
    with GLOBAL_TIMER("iteration_sample_target" if mixture
               else "iteration_fit_target", dev):
        out_mean, out_std = m.output_normalizer(stack, ybuf, mask)
        warm = m.TargetParams(
            raw_weights=m.weights_inverse(torch.full(
                (S, M), 1.0 / M, dtype=dtype, device=dev)),
            gp=params.gp)
        if cfg.fit_method == "map":
            params = _fit_target(*args, warm, Xbuf, ybuf, mask, out_mean,
                                 out_std, draws.restarts, cfg, fixed_trips)
        else:
            if cfg.fit_method == "vi":
                samples = _sample_target_vi(*args, warm, Xbuf, ybuf, mask,
                                            out_mean, out_std, draws, cfg)
            else:
                samples = _sample_target_hmc(*args, Xbuf, ybuf, mask,
                                             out_mean, out_std, draws, cfg,
                                             fixed_trips)
            # the last draw is carried into the next iteration's warm start
            params = fit_lib.tree_map(lambda leaf: leaf[:, -1], samples)
    # a posterior fit's draws (S, K) broadcast against a unit axis of the
    # study's arguments
    parts = (stack, Xbuf, ybuf, mask, out_mean, out_std)
    stack_a, Xbuf_a, *rest = _with_draw_axis(*parts) if mixture else parts
    with GLOBAL_TIMER("iteration_acq_state", dev):
        state = _study_acq_state(stack_a, source_cfg, target_cfg,
                                 samples if mixture else params, Xbuf_a,
                                 *rest, cfg.pruning_threshold)
    with GLOBAL_TIMER("iteration_propose", dev):
        x_star = _propose(stack_a, source_cfg, target_cfg, state, Xbuf_a,
                          draws.raw, cfg, mixture=mixture)
    with GLOBAL_TIMER("iteration_benchmark", dev):
        y_clean = benchmark_fn(x_star, task_params).to(dtype)
    y_noisy = y_clean + cfg.noise_std * draws.noise
    return x_star, y_clean, y_noisy, params, samples


def run_iteration(benchmark_fn: Callable, stack: m.SourceStack, task_params,
                  Xbuf, ybuf, yclean, mask, params: m.TargetParams,
                  draws: IterationDraws, i: int, source_cfg: gp.GPConfig,
                  target_cfg: gp.GPConfig, cfg: CampaignConfig):
    """One lock-step BO iteration of every study: refit, propose, evaluate.
    Returns the updated (Xbuf, ybuf, yclean, mask, params) and, after a
    posterior fit, its mixture draws (S, mixture_samples, ...) (else None);
    ``params`` is then the last draw of each study."""
    x_star, y_clean, y_noisy, params, samples = _refit_and_propose(
        benchmark_fn, stack, task_params, Xbuf, ybuf, mask, params, draws,
        source_cfg, target_cfg, cfg, False)
    Xbuf, ybuf, yclean, mask = (t.clone() for t in (Xbuf, ybuf, yclean, mask))
    Xbuf[:, i] = x_star
    ybuf[:, i] = y_noisy
    yclean[:, i] = y_clean
    mask[:, i] = 1.0
    return Xbuf, ybuf, yclean, mask, params, samples


def _at(stacked, index: torch.Tensor):
    """Entry ``index`` (a (1,) device tensor) of every leaf's leading
    iteration axis; absent (None) members stay absent."""
    return fit_lib.tree_map(
        lambda leaf: None if leaf is None else leaf.index_select(0, index)[0],
        stacked)


def device_iteration(benchmark_fn: Callable, stack: m.SourceStack,
                     task_params, bufs, params: m.TargetParams, stacked,
                     index: torch.Tensor, source_cfg: gp.GPConfig,
                     target_cfg: gp.GPConfig, cfg: CampaignConfig):
    """The device loop's body: ``run_iteration`` at the iteration held in
    ``index`` (a (1,) int64 tensor on the device), with the fixed-trip fit,
    so that under a capture nothing in it waits on the host (its stage
    timers then neither sync nor record).  It reads
    its draws at ``index`` from ``stacked`` (``IterationDraws`` with a
    leading iteration axis), writes the evaluation into ``bufs``
    ((Xbuf, ybuf, yclean, mask)) at ``index`` and the carried parameters
    into ``params``, both in place, and returns a posterior fit's mixture
    draws (else None)."""
    Xbuf, ybuf, yclean, mask = bufs
    x_star, y_clean, y_noisy, new, samples = _refit_and_propose(
        benchmark_fn, stack, task_params, Xbuf, ybuf, mask, params,
        _at(stacked, index), source_cfg, target_cfg, cfg, True)
    for buf, value in ((Xbuf, x_star), (ybuf, y_noisy), (yclean, y_clean),
                       (mask, torch.ones_like(y_noisy))):
        buf.index_copy_(1, index, value.unsqueeze(1))
    for dst, src in zip(fit_lib.tree_leaves(params),
                        fit_lib.tree_leaves(new)):
        dst.copy_(src)
    return samples


def _stack_draws(draws: list) -> IterationDraws:
    """Iterations' ``IterationDraws`` stacked on a leading iteration axis;
    absent (None) members stay absent."""
    return fit_lib.tree_map(
        lambda *leaves: None if leaves[0] is None else torch.stack(leaves),
        *draws)


@contextlib.contextmanager
def _sync_errors():
    """Any operation that synchronizes the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _device_loop(step: Callable, runs: list, E: int, counts: list,
                 at_once: bool = False):
    """Run ``step(run)`` (one iteration of a run's rows, then its index
    advanced) for iterations 0 .. E-1 of every run, each iteration's runs
    in ``run_slots``, at once where ``at_once``.  Appends each iteration's
    cumulative launch counts to ``counts``; returns (iteration seconds,
    graph statistics or None).

    On the CPU every iteration runs eagerly, the runs in ``run_slots``.  On
    a card iteration 0 runs eagerly on a side stream (the warm-up: the
    kernels are built, loaded and configured there), the runs in
    ``run_slots``; then each run's ``step`` is captured once as a
    ``torch.cuda.CUDAGraph``, on a capture stream of the run's device, and
    replayed for iterations 1 .. E-1, each run's replays on a stream of its
    own, with no host synchronization between replays.  The captures run
    one after another in the caller's thread: PyTorch allows one capture
    at a time in a process (``torch.cuda.graph`` synchronizes the device
    and empties the allocator's cache on entry).  Capture and replays run
    under ``set_sync_debug_mode("error")``, which is global to the process
    and so set here, around every run; a failure to capture or replay
    raises.  Seconds are CUDA event times (the warm-up's, then each
    replay's).  A replay does not tick the kernels' launch counters: its
    launches in ``counts`` are those counted while its graph was
    captured.  The graph statistics hold, besides, each graph's kernel
    nodes by function name (``utils.cuda_graph.kernel_nodes``: what a
    replay launches, read from the graph itself; the seconds the walk
    took apart) and the device memory
    around the capture; the peaks count from the caller's last
    ``torch.cuda.reset_peak_memory_stats``, which this never calls."""
    devices = list(dict.fromkeys(torch.device(r["device"]) for r in runs))
    slots = [r["device"] for r in runs]

    def step_all():
        run_slots(lambda j: step(runs[j]), slots, at_once)

    if all(dev.type != "cuda" for dev in devices):
        seconds = []
        for _ in range(E):
            t0 = time.perf_counter()
            step_all()
            seconds.append(time.perf_counter() - t0)
            counts.append(inverse_mll.kernel_launches())
        return seconds, None
    if any(dev.type != "cuda" for dev in devices):
        raise ValueError("the device loop runs all rows on the CPU or all "
                         "on CUDA devices")

    def timed(body):
        """body() between CUDA events on every device's current stream;
        returns the events."""
        start, end = ({dev: torch.cuda.Event(enable_timing=True)
                       for dev in devices} for _ in range(2))
        for dev in devices:
            start[dev].record(torch.cuda.current_stream(dev))
        body()
        for dev in devices:
            end[dev].record(torch.cuda.current_stream(dev))
        return start, end

    replay_streams = [torch.cuda.Stream(run["device"]) for run in runs]

    def replay_all():
        """Each run's graph replayed on its own stream, after the caller's
        stream of its device and before the caller's next work there."""
        for run, stream in zip(runs, replay_streams):
            stream.wait_stream(torch.cuda.current_stream(run["device"]))
            with torch.cuda.stream(stream):
                run["graph"].replay()
        for run, stream in zip(runs, replay_streams):
            torch.cuda.current_stream(run["device"]).wait_stream(stream)

    for dev in devices:
        torch.cuda.synchronize(dev)
    # iteration 0, eagerly on a side stream of each device
    side = {dev: torch.cuda.Stream(dev) for dev in devices}
    for dev in devices:
        side[dev].wait_stream(torch.cuda.current_stream(dev))
    with contextlib.ExitStack() as streams:
        for dev in devices:
            streams.enter_context(torch.cuda.stream(side[dev]))
        events = [timed(step_all)]
    for dev in devices:
        torch.cuda.current_stream(dev).wait_stream(side[dev])
        torch.cuda.synchronize(dev)
    counts.append(inverse_mll.kernel_launches())
    stats = {"devices": [str(dev) for dev in devices],
             "peak_allocated_warmup": [torch.cuda.max_memory_allocated(dev)
                                       for dev in devices],
             "reserved_before_capture": [torch.cuda.memory_reserved(dev)
                                         for dev in devices],
             "capture_seconds": [], "instantiate_seconds": [],
             "kernel_nodes": [], "kernel_nodes_seconds": []}
    if E > 1:
        before = inverse_mll.kernel_launches()
        for run in runs:
            with torch.cuda.device(run["device"]):
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                t0 = time.perf_counter()
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(
                        run["device"])):
                    with _sync_errors():
                        step(run)
                stats["capture_seconds"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                graph.instantiate()
                torch.cuda.synchronize()
                stats["instantiate_seconds"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                stats["kernel_nodes"].append(cuda_graph.kernel_nodes(graph))
                stats["kernel_nodes_seconds"].append(
                    time.perf_counter() - t0)
                run["graph"] = graph
        after = inverse_mll.kernel_launches()
        per_replay = {k: after[k] - before[k] for k in after}
        stats["launches_per_replay"] = per_replay
        stats["reserved_after_capture"] = [torch.cuda.memory_reserved(dev)
                                           for dev in devices]
        with _sync_errors():
            for _ in range(1, E):
                events.append(timed(replay_all))
        for dev in devices:
            torch.cuda.synchronize(dev)
        for _ in range(1, E):
            counts.append({k: counts[-1][k] + per_replay.get(k, 0)
                           for k in counts[-1]})
    stats["peak_allocated"] = [torch.cuda.max_memory_allocated(dev)
                               for dev in devices]
    stats["peak_reserved"] = [torch.cuda.max_memory_reserved(dev)
                              for dev in devices]
    seconds = [max(start[dev].elapsed_time(end[dev]) for dev in devices)
               / 1e3 for start, end in events]
    return seconds, stats


def run_campaign(benchmark_fn: Callable, task_params, meta_data: m.TaskData,
                 seed: int = 0, source_cfg: Optional[gp.GPConfig] = None,
                 target_cfg: Optional[gp.GPConfig] = None,
                 cfg: CampaignConfig = CampaignConfig(),
                 meta_fit_restarts: int = 3, meta_fit_steps: int = 50,
                 meta_fit_chunks: int = 1, loop: str = "host",
                 mesh: Optional[Mesh] = None,
                 checkpoint_path=None, checkpoint_every: int = 10,
                 stop_after: Optional[int] = None,
                 study_chunk: Optional[int] = None,
                 device=None) -> CampaignResult:
    """Run S studies in lock-step.

    Args:
        benchmark_fn: ``(x_unit (S, d), task_params) -> (S,)`` noise-free
            loss.
        task_params: dict of (S,) per-study target-task parameters.
        meta_data: TaskData with leading axes (S, M, N) — per-study meta
            observations, already noisy if desired.
        seed: seeds the meta-fit's generator and, with the iteration,
            each iteration's (``iteration_generator``).
        loop: ``"host"``, the host loops over iterations; or ``"device"``,
            no iteration syncs with the host (``device_iteration``): all
            E iterations' draws are made first, and on a CUDA device
            iteration 0 runs eagerly and every later one is a replay of a
            CUDA graph captured once (``_device_loop``; its seconds and
            memory in ``CampaignResult.graph``).  The device loop equals
            the host loop bit for bit where the library takes the same
            algorithms under capture.  Not with ``checkpoint_path``,
            ``stop_after`` or ``study_chunk``.
        meta_fit_chunks: split the (S*M)-task meta-fit into this many equal
            sequential batches (must divide S).  The draws are made for all
            tasks first, so the result does not depend on the split.  Not
            with a mesh.
        mesh: a ``parallel.mesh.Mesh`` whose study axis splits the studies:
            S is padded to a multiple of its study extent by repeating
            study 0, and each study row of this process runs its studies,
            meta-fit and iterations, on the row's first slot (the task axis
            is not used here).  Every draw is made for all S studies and
            sliced, so a study's result does not depend on the layout.  On
            a mesh over several processes a process runs its own rows
            only: the rows of other processes' studies stay 0, with
            ``mask`` 0, and ``studies`` lists the studies it holds.
        checkpoint_path: write the campaign's state (``CampaignState``) to
            ``<checkpoint_path>.npz`` before the first iteration, every
            ``checkpoint_every`` iterations and at the end; if that file
            exists, the campaign resumes from it, its target tasks and
            meta-data taking the place of ``task_params`` and
            ``meta_data``.  Not on a mesh over several processes.
        stop_after: checkpoint and return after this many iterations (resume
            by calling again with the same ``checkpoint_path``).  Not with
            study chunks.
        study_chunk: run the BO loop over sequential chunks of at most this
            many studies instead of all S at once; ``None`` or 0 runs all
            S together.  Each study's result does not depend on the chunks
            (the draws are made for all S and sliced).  A chunk resumes
            from the iterations that its studies' ``mask`` shows done, so
            a checkpoint written chunked resumes only chunked, with the
            same ``study_chunk``.  Not with a mesh.
        device: where the inputs and results live; ``cuda`` when left out,
            or, with a mesh, the first slot of this process.
    """
    if loop not in ("host", "device"):
        raise ValueError(f"loop={loop!r}: 'host' or 'device'")
    if loop == "device":
        for name, value in (("checkpoint_path", checkpoint_path),
                            ("stop_after", stop_after),
                            ("study_chunk", study_chunk or None)):
            if value is not None:
                raise ValueError(f"{name} is for the host loop only, not "
                                 "with loop='device'")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} < 1")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        if study_chunk:
            raise ValueError("study_chunk does not combine with a mesh: its "
                             "study rows split the studies")
        if meta_fit_chunks != 1:
            raise ValueError("meta_fit_chunks does not combine with a mesh: "
                             "each study row fits its own tasks")
        if checkpoint_path is not None and mesh.num_processes > 1:
            raise NotImplementedError(
                "checkpoints of a campaign over several processes are not "
                "ported: a process holds its own studies' rows only")
        if device is None:
            device = mesh.task_devices()[0]
    device = resolve_device(device)
    source_cfg = source_cfg or gp.source_gp_config()
    target_cfg = target_cfg or gp.target_gp_config()
    with GLOBAL_TIMER("campaign_stage_inputs", device):
        meta_data = m.TaskData(*[leaf.to(device) for leaf in meta_data])
        task_params = {k: v.to(device) for k, v in task_params.items()}
    S, M, N, d = meta_data.X.shape
    dtype = meta_data.X.dtype
    E = cfg.n_evaluations
    T = S * M
    if S % meta_fit_chunks:
        raise ValueError(f"meta_fit_chunks={meta_fit_chunks} does not "
                         f"divide S={S}")
    chunk = study_chunk if study_chunk and study_chunk < S else 0
    if chunk and stop_after is not None:
        raise ValueError("stop_after is not supported with study chunking")

    # ---- restore, before the meta-fit: the checkpoint's targets and
    # meta-data replace the arguments ---------------------------------------
    state = CampaignState(
        task_params=task_params, meta_data=meta_data,
        X=torch.zeros((S, E, d), dtype=dtype, device=device),
        y=torch.zeros((S, E), dtype=dtype, device=device),
        y_clean=torch.zeros((S, E), dtype=dtype, device=device),
        mask=torch.zeros((S, E), dtype=dtype, device=device),
        params=m.init_target_params(target_cfg, M, d, dtype, device,
                                    batch_shape=(S,)),
        seed=torch.tensor(seed), completed=torch.tensor(0))
    resumed = checkpoint_path is not None and ckpt.exists(checkpoint_path)
    if resumed:
        state = ckpt.load_pytree_like(checkpoint_path, state)
        if int(state.seed) != seed:
            raise ValueError(f"the checkpoint at {checkpoint_path} was "
                             f"written with seed {int(state.seed)}, not "
                             f"{seed}")
    generator = torch.Generator(device="cpu").manual_seed(seed)

    # ---- the lanes (first study, end, device) that this process runs: the
    # chunks, the mesh's study rows, or all S on one device; a mesh pads
    # every study-axis tensor with copies of study 0 -------------------------
    if mesh is None:
        pad = 0
        lanes = ([(c0, min(c0 + chunk, S), device)
                  for c0 in range(0, S, chunk)] if chunk else [(0, S, device)])
    else:
        pad = pad_to_multiple(S, mesh.shape["study"]) - S
        mine = mesh.local_rows()
        lanes = [(a, b, mesh.devices[r, 0])
                 for r, a, b in mesh.study_slices(S) if r in mine]
    held = [s for a, b, _ in lanes for s in range(a, min(b, S))]
    at_once = mesh is not None and mesh.at_once
    task_params = {k: _pad_rows(v, pad) for k, v in state.task_params.items()}
    meta_data = _pad_rows(state.meta_data, pad)
    Xbuf, ybuf, yclean, mask = (_pad_rows(t, pad) for t in (
        state.X, state.y, state.y_clean, state.mask))
    params = _pad_rows(state.params, pad)

    # ---- meta-fit: (study, task) folded into one task axis ----------------
    t0 = time.perf_counter()
    counts = [inverse_mll.kernel_launches()]
    with GLOBAL_TIMER("campaign_meta_fit", device):
        flat = m.TaskData(*[leaf.reshape((-1,) + leaf.shape[2:])
                            for leaf in meta_data])
        warm = gp.init_params(source_cfg, d, dtype, device, batch_shape=(T,))
        sampled = gp.sample_params(source_cfg, generator, d, dtype,
                                   batch_shape=(T, meta_fit_restarts))
        init_stack = fit_lib.stack_restarts(warm, _to(sampled, device), 1)
        init_stack = fit_lib.tree_map(
            lambda leaf: _pad_rows(leaf.reshape((S, M) + leaf.shape[1:]),
                                   pad).reshape((-1,) + leaf.shape[1:]),
            init_stack)
        if mesh is None:
            csz = T // meta_fit_chunks
            pieces = [(c * csz, (c + 1) * csz, device)
                      for c in range(meta_fit_chunks)]
        else:
            pieces = [(a * M, b * M, dev) for a, b, dev in lanes]
        inputs = [(_to(_rows(flat, a, b), dev),
                   _to(_rows(init_stack, a, b), dev)) for a, b, dev in pieces]

        def fit_piece(j):
            return m.meta_fit_task_stack(
                inputs[j][0], source_cfg, num_steps=meta_fit_steps,
                mll_method=cfg.mll_method, init_stack=inputs[j][1],
                route_blocked=cfg.route_blocked,
                sweep_variant=cfg.sweep_variant)

        # meta-fit chunks one after another; a mesh's rows at once where
        # it says so
        parts = run_slots(fit_piece, [dev for *_, dev in pieces], at_once)
        parts = [fit_lib.tree_map(
            lambda leaf: leaf.reshape((-1, M) + leaf.shape[1:]), part)
            for part in parts]
        stack = cat_rows(parts, device)
        if mesh is None:
            lane_stacks = [_rows(stack, a, b) for a, b, _ in lanes]
        else:   # the rows of the studies held, padding left out
            lane_stacks = parts
            keep = torch.as_tensor([s < S for a, b, _ in lanes
                                    for s in range(a, b)], device=device)
            stack = fit_lib.tree_map(lambda leaf: leaf[keep], stack)
    meta_fit_seconds = time.perf_counter() - t0
    counts.append(inverse_mll.kernel_launches())
    nonfinite = ~(torch.isfinite(stack.chol).flatten(2).all(-1)
                  & torch.isfinite(stack.alpha).all(-1))

    # ---- BO loop ----------------------------------------------------------
    def save():
        with GLOBAL_TIMER("campaign_checkpoint", device):
            done = int(mask[:S].sum(-1).min())
            ckpt.save_pytree(checkpoint_path, CampaignState(
                {k: v[:S] for k, v in task_params.items()},
                _rows(meta_data, 0, S), Xbuf[:S], ybuf[:S], yclean[:S],
                mask[:S], _rows(params, 0, S), torch.tensor(seed),
                torch.tensor(done)))

    if checkpoint_path is not None and not resumed:
        save()   # pins the unseeded targets on disk before any iteration
    done = mask.sum(-1).round().long().cpu()
    if resumed and not chunk and done.unique().numel() > 1:
        raise ValueError(
            "checkpoint has per-study progress at different iterations "
            "(written by a study-chunked campaign); resume with the same "
            "study_chunk setting instead of study_chunk=0")
    # chunks run one after another; a mesh's rows run each iteration in
    # turn, or at once where it says so
    pairs = list(zip(lanes, lane_stacks))
    groups = [[pair] for pair in pairs] if chunk else [pairs]
    iteration_seconds = []
    stopped = False
    samples = None
    graph = None

    def lane_runs(group):
        """Each lane's rows on its device."""
        return [{"rows": (a, b), "device": dev, "stack": st,
                 "task_params": {k: v[a:b].to(dev)
                                 for k, v in task_params.items()},
                 "bufs": [t[a:b].to(dev) for t in (Xbuf, ybuf, yclean, mask)],
                 "params": _to(_rows(params, a, b), dev), "samples": None}
                for (a, b, dev), st in group]

    def merge(runs):
        """The runs' buffers and parameters into the full ones."""
        for run in runs:
            a, b = run["rows"]
            for full, part in zip((Xbuf, ybuf, yclean, mask,
                                   *fit_lib.tree_leaves(params)),
                                  (*run["bufs"],
                                   *fit_lib.tree_leaves(run["params"]))):
                full[a:b] = part.to(full.device)

    def merge_samples(runs):
        """The runs' last mixture draws into the full ones, NaN for the
        studies not run here."""
        nonlocal samples
        for run in runs:
            smp = run["samples"]
            if smp is None:
                continue
            if samples is None:
                samples = fit_lib.tree_map(
                    lambda leaf: leaf.new_full(
                        (S + pad,) + leaf.shape[1:], torch.nan,
                        device=device), smp)
            a, b = run["rows"]
            for full, part in zip(fit_lib.tree_leaves(samples),
                                  fit_lib.tree_leaves(smp)):
                full[a:b] = part.to(device)

    with GLOBAL_TIMER("campaign_bo_loop", device):
        if loop == "device":
            # every iteration's draws, made as the host loop makes them
            all_draws = [_pad_rows(iteration_draws(
                iteration_generator(seed, i), cfg, target_cfg, S, M, d,
                dtype, device), pad) for i in range(E)]
            runs = lane_runs(pairs)
            for run in runs:   # static buffers of the run's own
                a, b = run["rows"]
                dev = run["device"]
                run["bufs"] = [t.clone() for t in run["bufs"]]
                run["params"] = fit_lib.tree_map(torch.clone, run["params"])
                run["draws"] = _stack_draws(
                    [_to(_rows(dr, a, b), dev) for dr in all_draws])
                run["index"] = torch.zeros(1, dtype=torch.long, device=dev)
            del all_draws

            def step(run):
                run["samples"] = device_iteration(
                    benchmark_fn, run["stack"], run["task_params"],
                    run["bufs"], run["params"], run["draws"], run["index"],
                    source_cfg, target_cfg, cfg)
                run["index"].add_(1)

            iteration_seconds, graph = _device_loop(step, runs, E, counts,
                                                    at_once)
            merge(runs)
            merge_samples(runs)
            groups = []
        for group in groups:
            (c0, c1, _), _ = group[0]
            d_c = torch.cat([done[a:b] for (a, b, _), _ in group])
            if int(d_c.max()) != int(d_c.min()):
                raise ValueError(
                    "checkpoint has per-study progress at different "
                    f"iterations within study chunk [{c0}, {c1}) (min "
                    f"{int(d_c.min())}, max {int(d_c.max())}); it was written "
                    "with a different study_chunk — resume with the same "
                    "study_chunk setting as the run that wrote it")
            i0 = int(d_c.min())
            if i0 >= E:
                continue
            runs = lane_runs(group)
            for i in range(i0, E):
                t0 = time.perf_counter()
                with GLOBAL_TIMER("campaign_iteration", device):
                    with GLOBAL_TIMER("iteration_draws", device):
                        draws = _pad_rows(iteration_draws(
                            iteration_generator(seed, i), cfg, target_cfg, S,
                            M, d, dtype, device), pad)
                    row_draws = [_to(_rows(draws, *run["rows"]),
                                     run["device"]) for run in runs]

                    def row(j):
                        run = runs[j]
                        return run_iteration(
                            benchmark_fn, run["stack"], run["task_params"],
                            *run["bufs"], run["params"], row_draws[j], i,
                            source_cfg, target_cfg, cfg)

                    outs = run_slots(row, [run["device"] for run in runs],
                                     at_once)
                    for run, out in zip(runs, outs):
                        *run["bufs"], run["params"], run["samples"] = out
                iteration_seconds.append(time.perf_counter() - t0)
                counts.append(inverse_mll.kernel_launches())
                stopped = stop_after is not None and i + 1 >= i0 + stop_after
                last = i + 1 == E or stopped
                if last or (checkpoint_path is not None
                            and (i + 1) % checkpoint_every == 0):
                    merge(runs)
                    if checkpoint_path is not None:
                        save()
                if last:
                    merge_samples(runs)
                if stopped:
                    break
            if stopped:
                break
    return CampaignResult(X=Xbuf[:S], y=ybuf[:S], y_clean=yclean[:S],
                          meta_fit_seconds=meta_fit_seconds,
                          iteration_seconds=iteration_seconds,
                          launches={k: [b[k] - a[k] for a, b in
                                        zip(counts, counts[1:])]
                                    for k in counts[0]},
                          nonfinite_source_tasks=int(nonfinite.sum()),
                          mask=mask[:S],
                          samples=(None if samples is None
                                   else _rows(samples, 0, S)),
                          stack=stack, studies=torch.tensor(held),
                          graph=graph)


def simple_regret(y_clean: torch.Tensor, optimum) -> torch.Tensor:
    """Running-min simple regret per study (plotting.py:21-53 semantics)."""
    regret = y_clean - torch.as_tensor(optimum, dtype=y_clean.dtype,
                                       device=y_clean.device)[..., None]
    return torch.cummin(regret, dim=-1).values
