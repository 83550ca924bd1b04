"""Study runner (``scamlgp_tpu/benchmarking/local_runner.py``, the
reference's ``local_runner.py:31-84``): ``run_study`` runs one seeded BO
study, noise-wrapped when a noise model is given, and keeps both the noisy
and the noise-free objectives.

Only ``run_study`` is ported; the campaign routing, ``submit``,
``visualize`` and ``main`` come with the experiment layer.  The study runs
where its optimizer runs: ``ScaMLGPBO`` on ``cuda`` unless
``optimizer_kwargs`` name a ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np

from scamlgp_tpu_torch.benchmarking.bbo_helper import run_with_bbo
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base as BenchmarkBase
from scamlgp_tpu_torch.benchmarking.noise.base import NoiseBase
from scamlgp_tpu_torch.benchmarking.noise.benchmark import NoisyBenchmark
from scamlgp_tpu_torch.bo.core import EvaluationSpecification


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
