"""Benchmark discovery, meta-data noising, and the experiment CLI
(``scamlgp_tpu/benchmarking/utils.py``, the reference's
``benchmarking/utils.py:29-309``): discovery by package introspection, the
``submit | visualize | hash`` modes, and the merge of the per-seed result
JSONs.  The CLI is a plain function (``run_experiment_cli``) with one
handler per mode; the decorator is a thin adapter for the bespoke figure
modules.

``submit`` takes ``--device`` (the card, ``cuda``, unless named), as
``validate.py`` does; ``hash`` prints the JAX package's hashes
(``experiment_config_utils``).  ``visualize`` draws with matplotlib, which
``plotting`` imports only when it draws.
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import scamlgp_tpu_torch.benchmarking.benchmarks as _benchmarks_pkg
from scamlgp_tpu_torch.benchmarking.benchmarks.api import Benchmark, SeedType
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import (
    Experiment,
    get_experiments_config_from_module,
    hash_experiment_config,
)
from scamlgp_tpu_torch.benchmarking.local_runner import REPO_ROOT
from scamlgp_tpu_torch.benchmarking.local_runner import main as _run_locally
from scamlgp_tpu_torch.bo.core import Evaluation

logger = logging.getLogger("scamlgp_tpu_torch")


# --------------------------------------------------------------------------
# benchmark discovery


def _iter_benchmark_classes() -> Iterator[type]:
    for name in dir(_benchmarks_pkg):
        obj = getattr(_benchmarks_pkg, name)
        if inspect.isclass(obj) and issubclass(obj, Benchmark):
            yield obj


def get_benchmarks() -> List[Benchmark]:
    """Every benchmark class the benchmarks package re-exports
    (introspection-based discovery, reference ``utils.py:29-43``)."""
    return list(_iter_benchmark_classes())


def _benchmarks_where(predicate: Callable[[Benchmark], bool]
                      ) -> List[Benchmark]:
    """Filter discovered benchmarks by a predicate on a default-constructed
    instance; classes that cannot be instantiated here (e.g. tabular
    benchmarks without their data blobs) are skipped with a warning."""
    keep = []
    for cls in _iter_benchmark_classes():
        try:
            if predicate(cls()):
                keep.append(cls)
        except (TypeError, ImportError, FileNotFoundError, ValueError):
            logging.warning(f"Could not instantiate benchmark '{cls}'.")
    return keep


def get_benchmarks_with_search_space_dimensions(dimensions: int
                                                ) -> List[Benchmark]:
    """Benchmarks with a ``dimensions``-dimensional search space
    (reference ``utils.py:46-69``)."""
    return _benchmarks_where(lambda b: len(b.search_space) == dimensions)


def get_benchmarks_with_output_dimensions(dimensions: int) -> List[Benchmark]:
    """Benchmarks with ``dimensions`` output dimensions
    (reference ``utils.py:72-95``)."""
    return _benchmarks_where(lambda b: b.output_dimensions == dimensions)


# --------------------------------------------------------------------------
# meta-data noising


def add_noise_to_meta_data_objectives(
        meta_data: Dict[Union[str, int], List[Evaluation]],
        noise_scale: Union[float, Dict[str, float]],
        noise_is_relative: bool = False,
        seed: Optional[SeedType] = None
) -> Dict[Union[str, int], List[Evaluation]]:
    """Copy of ``meta_data`` with i.i.d. Gaussian noise added to every
    recorded objective value (reference ``utils.py:98-127``).

    ``noise_scale`` is either one float applied to the ``"loss"`` objective
    or a per-objective-name dict; with ``noise_is_relative`` the draw is
    scaled by the clean value.  One rng serves the whole structure, so the
    noise stream is a function of (iteration order, seed) exactly as in the
    reference.
    """
    scales = ({"loss": noise_scale} if isinstance(noise_scale, float)
              else dict(noise_scale))
    rng = np.random.default_rng(seed)
    noisy = copy.deepcopy(meta_data)
    for evaluations in noisy.values():
        for ev in evaluations:
            for name, value in ev.objectives.items():
                if value is None:
                    continue
                draw = scales[name] * rng.standard_normal()
                ev.objectives[name] = value + draw * (
                    value if noise_is_relative else 1.0)
    return noisy


# --------------------------------------------------------------------------
# results layout


def module_string(module_file) -> str:
    """Dotted module path of a file of the package, rooted at its last
    ``scamlgp_tpu_torch`` directory."""
    parts = Path(module_file).with_suffix("").parts
    root = len(parts) - 1 - parts[::-1].index("scamlgp_tpu_torch")
    return ".".join(parts[root:])


def get_module_string(func: Callable) -> str:
    """Dotted module path of the file defining ``func``, rooted at
    ``scamlgp_tpu_torch`` (reference ``utils.py:128-137``)."""
    return module_string(inspect.getmodule(func).__file__)


def _results_dir(module: str, name: str, config: Experiment,
                 output_root: Optional[Path] = None) -> Path:
    """``<root>/<module dirs>/results/<name>_<confighash>`` — the hashed
    layout ``local_runner.main`` writes (``local_runner.py:126-134``)."""
    root = Path(output_root) if output_root is not None else REPO_ROOT
    pkg_dir = Path(*module.split(".")[:-1])
    return root / pkg_dir / "results" / (
        f"{name}_{hash_experiment_config(config)}")


def load_results_from_disk(configurations: Dict[str, Experiment],
                           func_module_string: str,
                           output_root: Optional[Path] = None) -> dict:
    """Merge every per-seed result JSON found for each experiment into
    ``{name: info_dict + {"studies": [...]}}`` (reference
    ``utils.py:175-201``).  Experiments with no ``info.json`` on disk are
    reported and skipped; no cross-file consistency check is attempted,
    matching the reference."""
    merged = {}
    for name, config in configurations.items():
        exp_dir = _results_dir(func_module_string, name, config, output_root)
        try:
            info = json.loads((exp_dir / "info.json").read_text("UTF-8"))
        except FileNotFoundError:
            print(f"Unable to load results from {exp_dir}")
            continue
        info["studies"] = [
            study
            for f in sorted(exp_dir.glob("*.json"))
            if f.name != "info.json"
            for study in json.loads(f.read_text("UTF-8"))["studies"]
        ]
        merged[name] = info
    return merged


# --------------------------------------------------------------------------
# submit | visualize | hash CLI


def submit_local_job(config: Experiment, experiment_key: str,
                     experiment_module: str, max_workers: int,
                     hpobench_path: Optional[str] = None,
                     fcnet_path: Optional[str] = None,
                     force_host_runner: bool = False, device=None,
                     output_root: Optional[Path] = None):
    return _run_locally(
        config=config, experiment_module=experiment_module,
        experiment_key=experiment_key, max_workers=max_workers,
        hpobench_path=hpobench_path, fcnet_path=fcnet_path,
        output_root=output_root, force_host_runner=force_host_runner,
        device=device)


def _validate_experiments_table(module: str) -> None:
    table = get_experiments_config_from_module(module)
    if not isinstance(table, dict):
        raise ValueError(f"Module {module}.EXPERIMENTS needs to be a "
                         f"dictionary but is {type(table)}.")
    wrong = {k: type(v) for k, v in table.items()
             if not isinstance(v, Experiment)}
    if wrong:
        raise ValueError(f"Module {module}.EXPERIMENTS needs to contain "
                         f"exclusively Experiment instances but contains: "
                         f"{wrong}")


def _default_workers(config: Experiment) -> int:
    return min(64, os.cpu_count()) if config.compute == "PARALLEL" else 1


def _submit(selected: Dict[str, Experiment], module: str,
            args: argparse.Namespace) -> None:
    for name, config in selected.items():
        workers = (args.parallel_studies if args.parallel_studies is not None
                   else _default_workers(config))
        print(f"Starting {name} locally, using max {workers} processes")
        submit_local_job(config=config, experiment_key=name,
                         experiment_module=module,
                         hpobench_path=args.hpobench, fcnet_path=args.fcnet,
                         max_workers=workers,
                         force_host_runner=args.host_runner,
                         device=args.device, output_root=args.output_root)


def _print_hashes(selected: Dict[str, Experiment], module: str,
                  args: argparse.Namespace) -> None:
    for name, config in selected.items():
        print(hash_experiment_config(config), name)


def run_experiment_cli(module: str, experiments: Dict[str, Experiment],
                       plot_fn: Callable[[dict], object], argv=None):
    """Command-line front end for one experiment module: ``submit`` runs the
    selected experiments locally, ``visualize`` feeds merged on-disk results
    to ``plot_fn``, ``hash`` prints config fingerprints (reference
    ``utils.py:204-309``)."""
    _validate_experiments_table(module)

    parser = argparse.ArgumentParser(f"Benchmark experiment CLI ({module})")
    modes = parser.add_subparsers(
        title="modes", dest="mode", required=True,
        help="Submitting jobs or visualizing results")
    for mode, help_text in (("submit", "Submit configurations for "
                                       "evaluation"),
                            ("visualize", "Visualize results"),
                            ("hash", "Print config fingerprints")):
        sub = modes.add_parser(mode, help=help_text)
        sub.add_argument("configurations", nargs="+",
                         choices=["all"] + list(experiments))
    submit = modes.choices["submit"]
    submit.add_argument("--hpobench", type=str, default=None,
                        help="Directory of HPOBench tabular data.")
    submit.add_argument("--fcnet", type=str, default=None,
                        help="Directory of FCNet tabular data.")
    submit.add_argument("--parallel-studies", type=int, default=None,
                        help="Override per-config parallel study count "
                             "(default: 1, or min(64, cpus) when compute == "
                             "PARALLEL; a pool runs them on the CPU "
                             "only).")
    submit.add_argument("--host-runner", action="store_true",
                        help="Force the sequential per-study host runner "
                             "even when the experiment could run as one "
                             "lock-step campaign.")
    submit.add_argument("--device", default=None,
                        help="Device to run on (default: cuda).")
    for mode in ("submit", "visualize"):
        modes.choices[mode].add_argument(
            "--output-root", type=Path, default=None,
            help="Root of the results directories (default: the "
                 "repository).")

    args = parser.parse_args(argv)
    selected = (dict(experiments) if "all" in args.configurations
                else {k: experiments[k] for k in args.configurations})
    print("Selected configurations:", ", ".join(selected))

    if args.mode == "submit":
        _submit(selected, module, args)
    elif args.mode == "hash":
        _print_hashes(selected, module, args)
    else:
        return plot_fn(load_results_from_disk(selected, module,
                                              args.output_root))


def with_experiment_cli_and_data_loading(func):
    """Wrap a ``main(results)`` plotting function into the experiment CLI
    (adapter over ``run_experiment_cli`` for modules with bespoke plots —
    the standard regret grids use ``configurations._shared.regret_cli``)."""

    def wrapper(available_configs: Dict[str, Experiment], argv=None):
        return run_experiment_cli(get_module_string(func), available_configs,
                                  func, argv)

    return wrapper
