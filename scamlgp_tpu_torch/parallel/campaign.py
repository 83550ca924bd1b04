"""Lock-step BO campaigns: studies as a batch axis
(``scamlgp_tpu/parallel/campaign.py``, MAP mode, host loop).

One call runs S studies of a synthetic benchmark side by side: the meta-fit
of all S x M source GPs as one batch, then per iteration the target MAP fits
of all S studies x restarts as one batched L-BFGS, the UCB acquisition
ascent of all S studies x starts as one batched Adam, and the benchmark
evaluation.  The host loops over iterations only; with ``study_chunk`` it
runs the iterations of one chunk of studies after another.

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
``iteration_draws``, ``iteration_fit_target``, ``iteration_acq_state``,
``iteration_propose`` and ``iteration_benchmark``; checkpoint writes are
``campaign_checkpoint``.  Each stage synchronizes the card before its
clock is read.

Randomness comes from host ``torch.Generator`` s; their draws move to the
device.  The meta-fit's restarts come from one generator seeded with
``seed``.  Iteration i's draws, for all S studies at once, come from
``iteration_generator(seed, i)``, seeded from ``(seed, i)`` alone: a study
chunk takes its rows of the full draw, so chunking does not change what a
study sees, and a resumed campaign needs no generator state.
``iteration_draws`` makes one iteration's draws and ``run_iteration``
takes them as arguments, so tests can hand the JAX package and the port
the same draws.
"""

from __future__ import annotations

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
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.ops import inverse_mll
from scamlgp_tpu_torch.utils import checkpoint as ckpt
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    n_evaluations: int = 40
    noise_std: float = 1.0
    ucb_beta: float = 9.0                  # utils.py:215-224
    fit_method: str = "map"                # only "map" is ported
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
    # fields of the posterior-marginalized fits, not ported yet
    hmc_chains: int = 2
    hmc_warmup: int = 64
    hmc_samples: int = 16
    hmc_leapfrog: int = 12
    hmc_max_depth: int = 6
    mixture_samples: int = 8
    vi_steps: int = 200
    vi_mc: int = 8
    vi_lr: float = 0.05


class CampaignResult(NamedTuple):
    X: torch.Tensor        # (S, E, d) proposed unit-cube configs
    y: torch.Tensor        # (S, E) noisy observed losses
    y_clean: torch.Tensor  # (S, E) noise-free losses
    meta_fit_seconds: float
    iteration_seconds: list  # host clock per BO iteration run, device
    #                          synced (chunk after chunk in a chunked run)
    launches: dict           # kernel name -> launches in the meta-fit, then
    #                          in each iteration run (all 0 where no CUDA
    #                          tensor ran)
    nonfinite_source_tasks: int  # fitted source GPs whose cached factor
    #                              or alpha is not finite after the
    #                              meta-fit's Cholesky-route refit (their
    #                              study's predictions are then not finite)
    mask: torch.Tensor     # (S, E) 1 where the evaluation is filled: all
    #                        1 unless ``stop_after`` ended the run early


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
    """The random inputs of one lock-step iteration."""

    restarts: m.TargetParams   # (S, fit_restarts, ...) prior draws
    raw: torch.Tensor          # (S, acq_raw_samples, d) uniform candidates
    noise: torch.Tensor        # (S,) standard normal observation noise


def iteration_generator(seed: int, i: int) -> torch.Generator:
    """Iteration ``i``'s host generator, seeded with
    ``numpy.random.SeedSequence([seed, i]).generate_state(1, uint64)[0]``."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    return torch.Generator(device="cpu").manual_seed(int(state[0]))


def _rows(tree, c0: int, c1: int):
    """Rows c0:c1 of every leaf (the study axis) of a NamedTuple tree."""
    return fit_lib.tree_map(lambda leaf: leaf[c0:c1], tree)


def iteration_draws(generator: torch.Generator, cfg: CampaignConfig,
                    target_cfg: gp.GPConfig, S: int, M: int, d: int,
                    dtype, device) -> IterationDraws:
    restarts = m.sample_target_params(target_cfg, generator, M, d, dtype,
                                      batch_shape=(S, cfg.fit_restarts))
    raw = torch.rand((S, cfg.acq_raw_samples, d), generator=generator,
                     dtype=dtype, device=generator.device)
    noise = torch.randn((S,), generator=generator, dtype=dtype,
                        device=generator.device)
    return IterationDraws(
        restarts=fit_lib.tree_map(lambda leaf: leaf.to(device), restarts),
        raw=raw.to(device), noise=noise.to(device))


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


def _fit_target(stack, source_cfg, target_cfg, params_warm, Xbuf, ybuf, mask,
                out_mean, out_std, restarts: m.TargetParams,
                cfg: CampaignConfig) -> m.TargetParams:
    """Warm + prior-restart L-BFGS MAP fit of the target parameters of every
    study (training-mode cached source moments).  ``restarts`` carries the
    prior draws with leading (..., fit_restarts) axes."""
    means, covs = m.source_predict(stack, source_cfg, Xbuf, full_cov=True)
    om, os_ = out_mean[..., None], out_std[..., None]
    y_std = (ybuf - om) / os_ * mask
    batch_ndim = out_mean.ndim
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

    stack0 = fit_lib.stack_restarts(params_warm, restarts, batch_ndim)
    return fit_lib.fit_map_restarts(objective, stack0, num_steps=cfg.fit_steps,
                                    batch_ndim=batch_ndim).params


def _propose(stack, source_cfg, target_cfg, state, Xbuf, raw,
             cfg: CampaignConfig) -> torch.Tensor:
    """UCB(beta, minimize) ascent over the unit cube for every study: the
    raw sweep picks the top-k starts, then Adam ascends from each."""
    ucb = UpperConfidenceBound(beta=cfg.ucb_beta)

    def acq(x):
        mu, var = _study_posterior_diag_fast(stack, source_cfg, target_cfg,
                                             state, Xbuf, x)
        return ucb(mu, var)

    starts = top_starts(acq, raw, cfg.acq_topk)
    zs, negv = ascend(lambda x: -acq(x), starts, cfg.acq_steps, cfg.acq_lr)
    best = torch.argmin(torch.where(torch.isfinite(negv), negv, torch.inf),
                        dim=-1)
    z = torch.gather(zs, -2, best[..., None, None].expand(
        best.shape + (1, zs.shape[-1]))).squeeze(-2)
    return torch.sigmoid(z)


def run_iteration(benchmark_fn: Callable, stack: m.SourceStack, task_params,
                  Xbuf, ybuf, yclean, mask, params: m.TargetParams,
                  draws: IterationDraws, i: int, source_cfg: gp.GPConfig,
                  target_cfg: gp.GPConfig, cfg: CampaignConfig):
    """One lock-step BO iteration of every study: refit, propose, evaluate.
    Returns the updated (Xbuf, ybuf, yclean, mask, params)."""
    S, M = stack.data.X.shape[:2]
    dtype, dev = Xbuf.dtype, Xbuf.device
    with GLOBAL_TIMER("iteration_fit_target", dev):
        out_mean, out_std = m.output_normalizer(stack, ybuf, mask)
        warm = m.TargetParams(
            raw_weights=m.weights_inverse(torch.full(
                (S, M), 1.0 / M, dtype=dtype, device=dev)),
            gp=params.gp)
        params = _fit_target(stack, source_cfg, target_cfg, warm, Xbuf, ybuf,
                             mask, out_mean, out_std, draws.restarts, cfg)
    with GLOBAL_TIMER("iteration_acq_state", dev):
        state = _study_acq_state(stack, source_cfg, target_cfg, params, Xbuf,
                                 ybuf, mask, out_mean, out_std,
                                 cfg.pruning_threshold)
    with GLOBAL_TIMER("iteration_propose", dev):
        x_star = _propose(stack, source_cfg, target_cfg, state, Xbuf,
                          draws.raw, cfg)
    with GLOBAL_TIMER("iteration_benchmark", dev):
        y_clean = benchmark_fn(x_star, task_params).to(dtype)
    y_noisy = y_clean + cfg.noise_std * draws.noise
    Xbuf, ybuf, yclean, mask = (t.clone() for t in (Xbuf, ybuf, yclean, mask))
    Xbuf[:, i] = x_star
    ybuf[:, i] = y_noisy
    yclean[:, i] = y_clean
    mask[:, i] = 1.0
    return Xbuf, ybuf, yclean, mask, params


def run_campaign(benchmark_fn: Callable, task_params, meta_data: m.TaskData,
                 seed: int = 0, source_cfg: Optional[gp.GPConfig] = None,
                 target_cfg: Optional[gp.GPConfig] = None,
                 cfg: CampaignConfig = CampaignConfig(),
                 meta_fit_restarts: int = 3, meta_fit_steps: int = 50,
                 meta_fit_chunks: int = 1, loop: str = "host", mesh=None,
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
        meta_fit_chunks: split the (S*M)-task meta-fit into this many equal
            sequential batches (must divide S).  The draws are made for all
            tasks first, so the result does not depend on the split.
        checkpoint_path: write the campaign's state (``CampaignState``) to
            ``<checkpoint_path>.npz`` before the first iteration, every
            ``checkpoint_every`` iterations and at the end; if that file
            exists, the campaign resumes from it, its target tasks and
            meta-data taking the place of ``task_params`` and
            ``meta_data``.
        stop_after: checkpoint and return after this many iterations (resume
            by calling again with the same ``checkpoint_path``).  Not with
            study chunks.
        study_chunk: run the BO loop over sequential chunks of at most this
            many studies instead of all S at once; ``None`` or 0 runs all
            S together.  Each study's result does not depend on the chunks
            (the draws are made for all S and sliced).  A chunk resumes
            from the iterations that its studies' ``mask`` shows done, so
            a checkpoint written chunked resumes only chunked, with the
            same ``study_chunk``.
        device: where the campaign runs; ``cuda`` when left out.
    """
    if cfg.fit_method != "map":
        raise NotImplementedError(
            f"fit_method={cfg.fit_method!r}: only 'map' is ported")
    if loop != "host":
        raise NotImplementedError(f"loop={loop!r}: only 'host' is ported")
    if mesh is not None:
        raise NotImplementedError("study sharding over a mesh is not ported")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} < 1")
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
        task_params, meta_data = state.task_params, state.meta_data
    generator = torch.Generator(device="cpu").manual_seed(seed)

    # ---- meta-fit: (study, task) folded into one task axis ----------------
    t0 = time.perf_counter()
    counts = [inverse_mll.kernel_launches()]
    with GLOBAL_TIMER("campaign_meta_fit", device):
        flat = m.TaskData(*[leaf.reshape((T,) + leaf.shape[2:])
                            for leaf in meta_data])
        warm = gp.init_params(source_cfg, d, dtype, device, batch_shape=(T,))
        sampled = gp.sample_params(source_cfg, generator, d, dtype,
                                   batch_shape=(T, meta_fit_restarts))
        init_stack = fit_lib.stack_restarts(
            warm, fit_lib.tree_map(lambda leaf: leaf.to(device), sampled), 1)
        csz = T // meta_fit_chunks
        parts = []
        for c in range(meta_fit_chunks):
            sl = slice(c * csz, (c + 1) * csz)
            parts.append(m.meta_fit_task_stack(
                m.TaskData(*[leaf[sl] for leaf in flat]), source_cfg,
                num_steps=meta_fit_steps, mll_method=cfg.mll_method,
                init_stack=fit_lib.tree_map(lambda leaf: leaf[sl],
                                            init_stack),
                route_blocked=cfg.route_blocked,
                sweep_variant=cfg.sweep_variant))
        flat_stack = fit_lib.tree_map(lambda *ls: torch.cat(ls), *parts)
        stack = fit_lib.tree_map(
            lambda leaf: leaf.reshape((S, M) + leaf.shape[1:]), flat_stack)
    meta_fit_seconds = time.perf_counter() - t0
    counts.append(inverse_mll.kernel_launches())
    nonfinite = ~(torch.isfinite(flat_stack.chol).flatten(1).all(-1)
                  & torch.isfinite(flat_stack.alpha).all(-1))

    # ---- BO loop ----------------------------------------------------------
    Xbuf, ybuf, yclean, mask, params = (state.X, state.y, state.y_clean,
                                        state.mask, state.params)

    def save():
        with GLOBAL_TIMER("campaign_checkpoint", device):
            done = int(mask.sum(-1).min())
            ckpt.save_pytree(checkpoint_path, CampaignState(
                task_params, meta_data, Xbuf, ybuf, yclean, mask, params,
                torch.tensor(seed), torch.tensor(done)))

    if checkpoint_path is not None and not resumed:
        save()   # pins the unseeded targets on disk before any iteration
    done = mask.sum(-1).round().long().cpu()
    if resumed and not chunk and done.unique().numel() > 1:
        raise ValueError(
            "checkpoint has per-study progress at different iterations "
            "(written by a study-chunked campaign); resume with the same "
            "study_chunk setting instead of study_chunk=0")
    bounds = ([(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
              if chunk else [(0, S)])
    iteration_seconds = []
    stopped = False
    with GLOBAL_TIMER("campaign_bo_loop", device):
        for c0, c1 in bounds:
            d_c = done[c0:c1]
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
            st_c, tp_c = _rows(stack, c0, c1), {k: v[c0:c1] for k, v in
                                                task_params.items()}
            Xb, yb, yc, mk = (t[c0:c1] for t in (Xbuf, ybuf, yclean, mask))
            pr = _rows(params, c0, c1)
            for i in range(i0, E):
                t0 = time.perf_counter()
                with GLOBAL_TIMER("campaign_iteration", device):
                    with GLOBAL_TIMER("iteration_draws", device):
                        draws = _rows(iteration_draws(
                            iteration_generator(seed, i), cfg, target_cfg, S,
                            M, d, dtype, device), c0, c1)
                    Xb, yb, yc, mk, pr = run_iteration(
                        benchmark_fn, st_c, tp_c, Xb, yb, yc, mk, pr, draws,
                        i, source_cfg, target_cfg, cfg)
                iteration_seconds.append(time.perf_counter() - t0)
                counts.append(inverse_mll.kernel_launches())
                stopped = stop_after is not None and i + 1 >= i0 + stop_after
                last = i + 1 == E or stopped
                if last or (checkpoint_path is not None
                            and (i + 1) % checkpoint_every == 0):
                    for full, part in zip(
                            (Xbuf, ybuf, yclean, mask,
                             *fit_lib.tree_leaves(params)),
                            (Xb, yb, yc, mk, *fit_lib.tree_leaves(pr))):
                        full[c0:c1] = part
                    if checkpoint_path is not None:
                        save()
                if stopped:
                    break
            if stopped:
                break
    return CampaignResult(X=Xbuf, y=ybuf, y_clean=yclean,
                          meta_fit_seconds=meta_fit_seconds,
                          iteration_seconds=iteration_seconds,
                          launches={k: [b[k] - a[k] for a, b in
                                        zip(counts, counts[1:])]
                                    for k in counts[0]},
                          nonfinite_source_tasks=int(nonfinite.sum()),
                          mask=mask)


def simple_regret(y_clean: torch.Tensor, optimum) -> torch.Tensor:
    """Running-min simple regret per study (plotting.py:21-53 semantics)."""
    regret = y_clean - torch.as_tensor(optimum, dtype=y_clean.dtype,
                                       device=y_clean.device)[..., None]
    return torch.cummin(regret, dim=-1).values
