"""Study runner (``scamlgp_tpu/benchmarking/local_runner.py``, the
reference's ``local_runner.py:31-84``): ``run_study`` runs one seeded BO
study, noise-wrapped when a noise model is given, and keeps both the noisy
and the noise-free objectives.

``_campaign_routable`` and ``_submit_via_campaign`` route a whole synthetic
experiment through one lock-step campaign (``parallel/campaign.py``) on a
single device, with no mesh.  Only MAP fits are routable
(``fit_method="map"``, the default) until the posterior-marginalized fits
are ported: the JAX package routes ``hmc``, ``nuts`` and ``vi`` too.
``submit``, ``visualize`` and ``main`` come with the experiment layer.  A
study runs where its optimizer runs: ``ScaMLGPBO`` on ``cuda`` unless
``optimizer_kwargs`` name a ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.bbo_helper import run_with_bbo
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base as BenchmarkBase
from scamlgp_tpu_torch.benchmarking.noise.base import NoiseBase
from scamlgp_tpu_torch.benchmarking.noise.benchmark import NoisyBenchmark
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    TORCH_FUNCTIONS,
    campaign_inputs_from_benchmark,
    campaign_to_study_results,
)
from scamlgp_tpu_torch.bo.core import EvaluationSpecification
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO
from scamlgp_tpu_torch.parallel.campaign import CampaignConfig, run_campaign


def run_study(optimizer_cls: Type, optimizer_kwargs: Dict[str, Any],
              benchmark_cls: Type[BenchmarkBase],
              benchmark_kwargs: Dict[str, Any], max_evaluations: int,
              study_seed: int,
              noise_spec: Optional[NoiseBase] = None) -> dict:
    """One seeded study: benchmark (+ noise) -> BO loop -> result dict with
    ``optimum``, ``objectives``, ``evaluations`` and ``seed``."""
    if noise_spec is not None:
        noise_spec.rng = np.random.default_rng(study_seed)
        benchmark = NoisyBenchmark(
            benchmark_cls(**benchmark_kwargs, seed=study_seed), noise_spec)
    else:
        benchmark = benchmark_cls(**benchmark_kwargs, seed=study_seed)

    evaluations = run_with_bbo(
        benchmark=benchmark, optimizer_cls=optimizer_cls,
        optimizer_kwargs_from_config=optimizer_kwargs,
        max_evaluations=max_evaluations, meta_data_seed=study_seed)

    if isinstance(benchmark, NoisyBenchmark):
        # re-evaluate each config noise-free, store both objective variants
        # (reference :67-77)
        for ev in evaluations:
            spec = EvaluationSpecification(
                configuration=ev.configuration, settings=ev.settings,
                context=ev.context, optional_info=ev.optional_info)
            noise_free_eval = benchmark.noise_free_benchmark(spec)
            ev.objectives = {
                **{f"{n} (noisy)": v for n, v in ev.objectives.items()},
                **{f"{n} (noise free)": v
                   for n, v in noise_free_eval.objectives.items()},
            }

    return {
        "optimum": getattr(benchmark, "optimum", None),
        "objectives": [o.__dict__ for o in benchmark.objectives],
        "evaluations": [e.__dict__ for e in evaluations],
        "seed": study_seed,
    }


def _campaign_routable(optimizer_cls, optimizer_kwargs, benchmark_cls,
                       benchmark_kwargs, noise_spec) -> bool:
    """Whether an experiment can run as one lock-step campaign: a synthetic
    benchmark with a torch adapter, the default ``ScaMLGPBO`` (a
    ``fit_method`` of ``"map"`` and a ``device`` allowed), no benchmark
    option but ``n_data_per_task``, and homoscedastic noise on ``loss``
    or none."""
    return (benchmark_cls.__name__ in TORCH_FUNCTIONS
            and optimizer_cls is ScaMLGPBO
            and set(optimizer_kwargs) <= {"fit_method", "device"}
            and optimizer_kwargs.get("fit_method", "map") == "map"
            and set(benchmark_kwargs) == {"n_data_per_task"}
            and len(benchmark_kwargs["n_data_per_task"]) > 0
            and (noise_spec is None
                 or (type(noise_spec) is HomoscedasticGaussianNoise
                     and set(noise_spec.noise_std) >= {"loss"})))


def _submit_via_campaign(optimizer_kwargs, benchmark_cls, benchmark_kwargs,
                         noise_spec, n_evaluations: int, n_studies: int,
                         persist) -> None:
    """Run a routable experiment's studies (seeds 0 .. n_studies - 1) as one
    float32 lock-step campaign on ``optimizer_kwargs``' device (``cuda``
    by default), optima on the device, and hand each study's result dict,
    in ``run_study``'s schema, to ``persist``."""
    device = optimizer_kwargs.get("device")
    noise_std = (float(noise_spec.noise_std["loss"])
                 if noise_spec is not None else 0.0)
    seeds = list(range(n_studies))
    n_data = list(benchmark_kwargs["n_data_per_task"])
    fn, tps, md, optima = campaign_inputs_from_benchmark(
        benchmark_cls, n_data, seeds, noise_std=noise_std,
        dtype=torch.float32, device=device, optimum_method="device")
    cfg = CampaignConfig(n_evaluations=n_evaluations, noise_std=noise_std,
                         fit_method=optimizer_kwargs.get("fit_method", "map"))
    result = run_campaign(fn, tps, md, seed=0, cfg=cfg, device=device)
    for study in campaign_to_study_results(
            benchmark_cls, n_data, seeds, result, optima,
            noisy=noise_spec is not None):
        persist(study)
