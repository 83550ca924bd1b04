"""Torch-evaluable adapters of the synthetic benchmarks for lock-step
campaigns (the counterpart of ``scamlgp_tpu/benchmarking/jax_adapters.py``).

Bridges the host-side ``Benchmark`` objects (tasks, meta-data, optimum) to
batched torch functions over the unit cube.  Each function maps points
x_unit (..., d) and a dict of task parameters broadcastable to (...,) to
(...,) losses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.functions.branin import branin
from scamlgp_tpu_torch.benchmarking.functions.hartmann import (
    A3,
    A6,
    P3,
    P6,
    hartmann_function,
)
from scamlgp_tpu_torch.benchmarking.functions.quadratic import quadratic
from scamlgp_tpu_torch.bo.optimize import ascend, top_starts
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import scamlgp as m


def branin_unit(x_unit, p):
    """x_unit (..., 2) in [0,1]^2 -> Branin over x1 in [-5,10], x2 in
    [0,15]; p holds (...,) task parameters."""
    x1 = -5.0 + 15.0 * x_unit[..., 0]
    x2 = 15.0 * x_unit[..., 1]
    return branin(x1, x2, p["a"], p["b"], p["c"], p["r"], p["s"], p["t"])


def _alpha(p):
    return torch.stack([p["alpha1"], p["alpha2"], p["alpha3"], p["alpha4"]],
                       dim=-1)


def hartmann3_unit(x_unit, p):
    """x_unit (..., 3) in [0,1]^3 -> Hartmann 3-D with weights alpha1..4."""
    return hartmann_function(x_unit, _alpha(p), A3, P3)


def hartmann6_unit(x_unit, p):
    """x_unit (..., 6) in [0,1]^6 -> Hartmann 6-D with weights alpha1..4."""
    return hartmann_function(x_unit, _alpha(p), A6, P6)


def quadratic_unit(x_unit, p):
    """x_unit (..., 1) in [0,1] -> the quadratic over x in [-1, 1]."""
    x = -1.0 + 2.0 * x_unit[..., 0]
    return quadratic(x, p["a"], p["b"], p["c"])


TORCH_FUNCTIONS = {
    "Branin": branin_unit,
    "Hartmann3D": hartmann3_unit,
    "Hartmann6D": hartmann6_unit,
    "Quadratic": quadratic_unit,
}


def _task_param_dict(task) -> Dict[str, float]:
    return {**task.descriptors, **task.settings, **task.context}


def device_optima(fn, task_params, d: int, n_samples: int = 8192,
                  topk: int = 32, steps: int = 200, lr: float = 0.02,
                  seed: int = 0) -> torch.Tensor:
    """Per-study minima of a benchmark function on the campaign's device
    (``jax_adapters.device_optima``): uniform screening, then Adam on the
    logit of the ``topk`` best points, keeping the best value seen.  The
    screening points come from a host generator seeded with ``seed``, so
    they are not the JAX package's points."""
    first = next(iter(task_params.values()))
    S, dtype, device = first.shape[0], first.dtype, first.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pts = torch.rand((S, n_samples, d), generator=gen, dtype=dtype)
    tp = {k: v[:, None] for k, v in task_params.items()}
    starts = top_starts(lambda x: -fn(x, tp), pts.to(device), topk)
    _, best = ascend(lambda x: fn(x, tp), starts, steps, lr)
    return best.min(dim=-1).values


def campaign_inputs_from_benchmark(benchmark_cls, n_data_per_task,
                                   study_seeds, noise_std: float,
                                   meta_distribution: str = "random",
                                   dtype=torch.float64, device=None,
                                   optimum_method: str = "shgo"):
    """Build (benchmark_fn, task_params, meta TaskData, optima) for a batch
    of seeded studies of a synthetic benchmark.

    Per study seed: instantiate the benchmark with the seed, generate noisy
    meta-data, and record the noise-free optimum (host-side scipy SHGO) for
    regret.  ``task_params`` is a dict of (S,) tensors; ``meta_data`` has
    leading (S, M) axes.

    ``optimum_method`` is ``"shgo"`` (the reference's host-side scipy SHGO
    per study, tens of seconds per 6-D study) or ``"device"``
    (``device_optima``).
    """
    if optimum_method not in ("shgo", "device"):
        raise ValueError(f"unknown optimum_method: {optimum_method!r}")
    device = resolve_device(device)
    fn = TORCH_FUNCTIONS[benchmark_cls.__name__]

    task_param_list, task_data_list, optima = [], [], []
    for seed in study_seeds:
        b = benchmark_cls(n_data_per_task=list(n_data_per_task), seed=seed)
        rng = np.random.default_rng(seed)
        xs, ys = [], []
        md = b.get_meta_data(meta_distribution, seed=seed)
        for uid in sorted(md.keys(), key=str):
            evals = md[uid]
            X = np.stack([b.search_space.to_numerical(e.configuration)
                          for e in evals])
            y = np.asarray([e.objectives["loss"] for e in evals])
            y = y + noise_std * rng.standard_normal(y.shape)
            xs.append(X)
            ys.append(y)
        task_data_list.append(m.pack_task_data(xs, ys, dtype=dtype,
                                               device=device))
        task_param_list.append(_task_param_dict(b.target_task))
        if optimum_method == "shgo":
            optima.append(float(b.optimum))

    task_params = {k: torch.tensor([tp[k] for tp in task_param_list],
                                   dtype=dtype, device=device)
                   for k in task_param_list[0]}
    meta_data = m.TaskData(*[torch.stack(ls) for ls in zip(*task_data_list)])
    if optimum_method == "device":
        optima = device_optima(fn, task_params, meta_data.X.shape[-1])
    else:
        optima = torch.tensor(optima, dtype=dtype, device=device)
    return fn, task_params, meta_data, optima


def campaign_to_study_results(benchmark_cls, n_data_per_task, study_seeds,
                              result, optima, objective_name: str = "loss",
                              noisy: bool = True, space=None):
    """A ``CampaignResult`` as the study runner's per-study result dicts
    (``local_runner.run_study``'s schema: ``optimum``, ``objectives``,
    ``evaluations``, ``seed``), each proposal decoded into a configuration
    by the search space's ``from_numerical``.

    ``optima`` are the per-study optima that
    ``campaign_inputs_from_benchmark`` returned: the target task is drawn
    unseeded, so it cannot be rebuilt here.  The search space does not
    depend on the task, so one instance decodes every study's proposals.
    """
    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    X, y, y_clean = host(result.X), host(result.y), host(result.y_clean)
    optima = host(optima)
    if space is None:
        space = benchmark_cls(n_data_per_task=list(n_data_per_task),
                              seed=0).search_space
    studies = []
    for si, seed in enumerate(study_seeds):
        evaluations = []
        for e in range(X.shape[1]):
            if noisy:
                objectives = {
                    f"{objective_name} (noisy)": float(y[si, e]),
                    f"{objective_name} (noise free)": float(y_clean[si, e]),
                }
            else:
                objectives = {objective_name: float(y_clean[si, e])}
            evaluations.append({
                "configuration": space.from_numerical(X[si, e]),
                "objectives": objectives})
        studies.append({
            "optimum": float(optima[si]),
            "objectives": [{"name": objective_name,
                            "greater_is_better": False}],
            "evaluations": evaluations,
            "seed": int(seed),
        })
    return studies
