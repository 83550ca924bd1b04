"""Study runner and experiment entry point
(``scamlgp_tpu/benchmarking/local_runner.py``, the reference's
``local_runner.py:31-205``).

``run_study`` runs one seeded BO study, noise-wrapped when a noise model is
given, and keeps both the noisy and the noise-free objectives.  ``main``
runs every study seed of one experiment and writes one JSON per seed
beside an ``info.json`` with the parsed configuration and the environment,
in the directory the JAX package's ``main`` writes
(``<module dirs>/results/<key>_<hash>``; the hashes are equal,
``experiment_config_utils``).

``main`` routes an experiment, and logs the decision as the JAX ``main``
does:

- a synthetic experiment that ``_campaign_routable`` accepts runs as one
  lock-step campaign (``parallel/campaign.py``, ``_submit_via_campaign``)
  with the driver's ``fit_method``: ``"map"`` (the default), ``"hmc"``,
  ``"nuts"`` or ``"vi"``, the last three with the campaign's sampler
  settings, as the JAX package routes them;
- a tabular one that ``_tabular_campaign_routable`` accepts runs as one
  lock-step campaign over device-resident tables
  (``tabular_adapters.py``, ``_submit_via_tabular_campaign``);
- any other, or any with ``force_host_runner``, runs study by study
  through ``run_study`` and the sequential driver.

Everything runs on ``main``'s ``device``, ``cuda`` unless the caller names
another: the campaigns there, and ``ScaMLGPBO`` through its ``device``
argument.  Both campaigns run on any device, so unlike the JAX package,
which keeps the host runner on its CPU backend, the port routes by the
experiment alone.  The host runner runs its studies in this process, one
after another, except on the CPU with ``max_workers > 1``, where a process
pool runs them as the reference does.  No mesh: campaigns run on one
device, also where there are several cards (the JAX package lays a study
mesh over them).  The port's study rows run one after another, each
syncing with the host on every L-BFGS trip, so on one card a (2, 1) mesh
took 1.65x the batched campaign (PERF.md, the sharding layer), and rows
on distinct cards do not overlap yet.
"""

from __future__ import annotations

import concurrent.futures
import importlib.metadata
import inspect
import json
import logging
import multiprocessing
import time
import traceback
from functools import partial
from pathlib import Path
from typing import Any, Dict, Optional, Type

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.bbo_helper import run_with_bbo
from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base as BenchmarkBase
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import (
    Experiment,
    hash_experiment_config,
    parse_experiment_config,
)
from scamlgp_tpu_torch.benchmarking.noise.base import NoiseBase
from scamlgp_tpu_torch.benchmarking.noise.benchmark import NoisyBenchmark
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.benchmarking.tabular_adapters import (
    campaign_inputs_from_grid_tabular,
    campaign_inputs_from_pd1,
)
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    TORCH_FUNCTIONS,
    campaign_inputs_from_benchmark,
    campaign_to_study_results,
)
from scamlgp_tpu_torch.bo.core import EvaluationSpecification
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO
from scamlgp_tpu_torch.bo.space import CategoricalParameter, IntegerParameter
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.parallel.campaign import (
    FIT_METHODS,
    CampaignConfig,
    run_campaign,
)

REPO_ROOT = Path(__file__).parent.parent.parent.resolve()
logger = logging.getLogger("scamlgp_tpu_torch.runner")


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
    ``fit_method`` the campaign runs and a ``device`` allowed), no
    benchmark option but ``n_data_per_task``, and homoscedastic noise on
    ``loss`` or none."""
    return (benchmark_cls.__name__ in TORCH_FUNCTIONS
            and optimizer_cls is ScaMLGPBO
            and set(optimizer_kwargs) <= {"fit_method", "device"}
            and optimizer_kwargs.get("fit_method", "map") in FIT_METHODS
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


def _tabular_campaign_routable(optimizer_cls, optimizer_kwargs,
                               benchmark_cls, benchmark_kwargs,
                               noise_spec) -> bool:
    """Whether a tabular experiment can run as one lock-step campaign over
    device-resident tables: the default ``ScaMLGPBO`` (a ``fit_method``
    and a ``device`` allowed), no noise model (the published tabular
    configurations have none), and PD1, or a grid benchmark (FCNet,
    HPOBench) whose free search space is wholly discrete, so that the
    device's bin arithmetic is the host driver's ``from_numerical``."""
    if (optimizer_cls is not ScaMLGPBO
            or not set(optimizer_kwargs) <= {"fit_method", "device"}
            or noise_spec is not None):
        return False
    name = benchmark_cls.__name__
    if name == "PD1":
        return True
    if name not in ("FCNetFixedFidelityTabularBenchmark", "HPOBenchTabular"):
        return False
    try:
        b = benchmark_cls(seed=0, **benchmark_kwargs)
    except (ImportError, OSError, TypeError, ValueError):
        return False  # data or package absent: the host runner reports it
    return all(isinstance(p, (CategoricalParameter, IntegerParameter))
               for p in b.search_space._params
               if p.name not in b.search_space.fixed)


def _submit_via_tabular_campaign(optimizer_kwargs, benchmark_cls,
                                 benchmark_kwargs, n_evaluations: int,
                                 n_studies: int, persist) -> None:
    """Run a tabular experiment's studies (seeds 0 .. n_studies - 1) as one
    float32 lock-step campaign on ``optimizer_kwargs``' device (``cuda``
    by default): the tables ride in ``task_params`` and every evaluation
    is a gather (grid benchmarks) or a masked L1 argmin (PD1) on the
    device.  Each study's result dict, in ``run_study``'s schema, goes to
    ``persist``."""
    device = optimizer_kwargs.get("device")

    def factory(seed):
        return benchmark_cls(seed=seed, **benchmark_kwargs)

    seeds = list(range(n_studies))
    build = (campaign_inputs_from_pd1 if benchmark_cls.__name__ == "PD1"
             else campaign_inputs_from_grid_tabular)
    fn, tps, md, optima = build(factory, seeds, device=device)
    cfg = CampaignConfig(n_evaluations=n_evaluations, noise_std=0.0,
                         fit_method=optimizer_kwargs.get("fit_method", "map"))
    result = run_campaign(fn, tps, md, seed=0, cfg=cfg, device=device)
    b0 = factory(0)
    for study in campaign_to_study_results(
            benchmark_cls, [], seeds, result, optima,
            objective_name=b0.objectives[0].name, noisy=False,
            space=b0.search_space):
        persist(study)


def _environment_info() -> Dict[str, str]:
    env = {}
    for dist in importlib.metadata.distributions():
        try:
            env[dist.metadata["Name"]] = dist.version
        except Exception:
            continue
    return env


def _with_device(optimizer_cls, optimizer_kwargs: dict,
                 device: torch.device) -> dict:
    """The optimizer's kwargs with ``device`` added where its constructor
    takes one and the configuration names none."""
    if ("device" in optimizer_kwargs
            or "device" not in inspect.signature(optimizer_cls).parameters):
        return dict(optimizer_kwargs)
    return {**optimizer_kwargs, "device": str(device)}


def main(config: Experiment, experiment_module: str, experiment_key: str,
         max_workers: int, hpobench_path: Optional[str] = None,
         fcnet_path: Optional[str] = None,
         output_root: Optional[Path] = None,
         force_host_runner: bool = False, device=None) -> Path:
    """Run all study seeds of one experiment on ``device`` (``cuda`` unless
    named) and persist the results; returns the results directory
    (reference ``local_runner.py:87-205``)."""
    device = resolve_device(device)
    benchmark_kwargs = (dict(config.benchmark["kwargs"])
                        if isinstance(config.benchmark, dict) else {})
    if hpobench_path:
        benchmark_kwargs["data_dir"] = hpobench_path
    if fcnet_path:
        benchmark_kwargs["target_task_file"] = str(
            Path(fcnet_path) / "fcnet_tabular_benchmarks"
            / benchmark_kwargs["target_task_file"])
        benchmark_kwargs["meta_task_files"] = [
            str(Path(fcnet_path) / "fcnet_tabular_benchmarks" / mtf)
            for mtf in benchmark_kwargs["meta_task_files"]]

    config_hash = hash_experiment_config(config)
    root = Path(output_root) if output_root is not None else REPO_ROOT
    output_dir = (root / Path(*experiment_module.split(".")[:-1]) / "results"
                  / f"{experiment_key}_{config_hash}")
    output_dir.mkdir(parents=True, exist_ok=True)

    info = dict(
        experiment_config=parse_experiment_config(config.__dict__),
        experiment_module=experiment_module,
        experiment_key=experiment_key,
        environment=_environment_info(),
        timestamp=time.time(),
    )
    with open(output_dir / "info.json", "w", encoding="UTF-8") as fh:
        json.dump(info, fh)

    def _persist(benchmark_results: dict) -> None:
        study_seed = benchmark_results["seed"]
        results = dict(
            experiment_config=parse_experiment_config(config.__dict__),
            experiment_module=experiment_module,
            experiment_key=experiment_key,
            timestamp=time.time(),
            studies=[benchmark_results],
        )
        path = output_dir / f"{experiment_key}_{study_seed}_{config_hash}.json"
        with open(path, "w", encoding="UTF-8") as fh:
            json.dump(results, fh)

    if isinstance(config.optimizer, dict):
        optimizer_cls = config.optimizer["cls"]
        optimizer_kwargs = dict(config.optimizer["kwargs"])
    else:
        optimizer_cls, optimizer_kwargs = config.optimizer, {}
    optimizer_kwargs = _with_device(optimizer_cls, optimizer_kwargs, device)
    if isinstance(config.benchmark, dict):
        benchmark_cls = config.benchmark["cls"]
        noise_spec = config.benchmark.get("noise_spec", None)
    else:
        benchmark_cls, noise_spec = config.benchmark, None
    fit_method = optimizer_kwargs.get("fit_method", "map")

    # The routing decision is logged: the paths differ by hours of wall
    # clock, and a silent fallback would hide which one produced the
    # results.
    if not force_host_runner and _campaign_routable(
            optimizer_cls, optimizer_kwargs, benchmark_cls,
            benchmark_kwargs, noise_spec):
        logger.warning(
            "submit %s: routing through the lock-step campaign "
            "(device=%s, fit_method=%s)", experiment_key, device, fit_method)
        _submit_via_campaign(optimizer_kwargs, benchmark_cls,
                             benchmark_kwargs, noise_spec,
                             config.n_evaluations, config.n_studies,
                             _persist)
        return output_dir
    if not force_host_runner and _tabular_campaign_routable(
            optimizer_cls, optimizer_kwargs, benchmark_cls,
            benchmark_kwargs, noise_spec):
        logger.warning(
            "submit %s: routing through the device-resident TABLE campaign "
            "(device=%s, fit_method=%s)", experiment_key, device, fit_method)
        _submit_via_tabular_campaign(optimizer_kwargs, benchmark_cls,
                                     benchmark_kwargs, config.n_evaluations,
                                     config.n_studies, _persist)
        return output_dir
    reason = ("--host-runner requested" if force_host_runner
              else "experiment not campaign-routable (non-synthetic "
                   "benchmark, non-default optimizer kwargs, or non-"
                   "homoscedastic noise)")
    use_pool = max_workers > 1 and device.type == "cpu"
    logger.warning("submit %s: using the sequential host runner (%s; "
                   "device=%s, %s)", experiment_key, reason, device,
                   f"{max_workers} processes" if use_pool else "in process")

    _run_study = partial(
        run_study, optimizer_cls=optimizer_cls,
        optimizer_kwargs=optimizer_kwargs, benchmark_cls=benchmark_cls,
        benchmark_kwargs=benchmark_kwargs,
        max_evaluations=config.n_evaluations, noise_spec=noise_spec)
    if use_pool:
        # spawned workers: forking a process whose torch runs threads is
        # unsafe
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=max_workers,
                mp_context=multiprocessing.get_context("spawn")) as executor:
            futures = [executor.submit(_run_study, study_seed=seed)
                       for seed in range(config.n_studies)]
            for future in concurrent.futures.as_completed(futures):
                try:
                    _persist(future.result())
                except Exception:
                    print("Error loading result")
                    traceback.print_exc()
    else:
        for seed in range(config.n_studies):
            try:
                _persist(_run_study(study_seed=seed))
            except Exception:
                print("Error loading result")
                traceback.print_exc()
    return output_dir
