"""The shared regret-figure CLI of the experiment configuration
modules (``scamlgp_tpu/benchmarking/configurations/_shared.py``).

Every published configuration module renders the same artifact — a grid of
regret curves per experiment group, via ``plotting.grouped_results`` — and
exposes the same ``submit | visualize | hash`` CLI.  The reference repeats
that ``main`` body in all 17 modules; here the modules keep only their
experiment tables and declare the figure as data:

    main = regret_cli(__file__, EXPERIMENTS,
                      groups={"Branin\\n8 Tasks ..." : "BRANIN_T8_P32_N1"},
                      objective=Objective("loss", False))

Bespoke figures (``figure_synthetic``, ``ablations_summary``, the
``nn_tabular`` regret table) still use
``utils.with_experiment_cli_and_data_loading`` directly.  The figure
reaches ``plotting`` (and so matplotlib) only when it draws, so every
configuration module imports without matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

from scamlgp_tpu_torch.benchmarking.configurations.styles import OPTIMIZER_STYLES
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.benchmarking.utils import (
    module_string,
    run_experiment_cli,
)
from scamlgp_tpu_torch.bo.core import Objective

GroupSpec = Dict[str, Union[str, Sequence[str]]]


def _resolve_groups(groups: GroupSpec, experiments: Dict[str, Experiment]
                    ) -> Dict[str, list]:
    """Map each group title to its experiment configs.  A string value
    selects experiments by key prefix; a sequence selects exact keys."""
    resolved = {}
    for title, spec in groups.items():
        if isinstance(spec, str):
            resolved[title] = [v for k, v in experiments.items()
                               if k.startswith(spec)]
        else:
            resolved[title] = [experiments[k] for k in spec]
    return resolved


def regret_plot_fn(module_file: str, experiments: Dict[str, Experiment],
                   groups: GroupSpec, objective: Objective,
                   robust_variants: Sequence[bool] = (True, False),
                   use_benchmark_optimum: bool = True,
                   sharey: Optional[str] = None,
                   label_stats: bool = True,
                   after_plot: Optional[Callable] = None
                   ) -> Callable[[dict], None]:
    """Build the standard ``main(results)`` body: one regret-grid PDF per
    statistics variant, saved next to the module."""
    out_dir = Path(module_file).parent
    stem = Path(module_file).stem

    def plot(results: dict) -> None:
        from scamlgp_tpu_torch.benchmarking.plotting import grouped_results

        for robust in robust_variants:
            fig = grouped_results(
                list(results.values()),
                optimizer_styles=OPTIMIZER_STYLES,
                groups=_resolve_groups(groups, experiments),
                use_regrets=True,
                robust_statistics=robust,
                use_benchmark_optimum=use_benchmark_optimum,
                objective=objective,
                **({"sharey": sharey} if sharey else {}),
            )
            suffix = ""
            if label_stats:
                suffix = ("_median_25quant75" if robust else "_mean_sem")
            fig.savefig(out_dir / f"{stem}_benchmark_wise_regrets"
                                  f"{suffix}.pdf")
        if after_plot is not None:
            after_plot(results)

    return plot


def hpobench_experiments(scenario: str, n_tasks: int, n_points: int,
                         n_evaluations: int = 60, n_studies: int = 256
                         ) -> Dict[str, Experiment]:
    """Experiment table for one HPOBench tabular scenario (the published
    grid: lr/svm 28x64, rf 27x128, xgb 19x128, nn 7x128 — reference
    ``configurations/{lr,svm,rf,xgb,nn}_tabular.py``)."""
    from scamlgp_tpu_torch.benchmarking.benchmarks.hpo_bench_tabular import (
        HPOBenchTabular,
    )
    from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

    key = f"{scenario.upper()}_T{n_tasks}_P{n_points}_SCAMLGP"
    benchmark = {"cls": HPOBenchTabular,
                 "kwargs": {"scenario": scenario,
                            "n_data_per_task": [n_points] * n_tasks}}
    return {key: Experiment(benchmark=benchmark, optimizer=ScaMLGPBO,
                            n_evaluations=n_evaluations,
                            n_studies=n_studies, compute="PARALLEL")}


def regret_cli(module_file: str, experiments: Dict[str, Experiment],
               **plot_kwargs) -> Callable:
    """The full module entry point: ``main(EXPERIMENTS)`` parses the CLI and
    dispatches submit/visualize/hash, with the standard regret figure as the
    visualize action."""
    plot = regret_plot_fn(module_file, experiments, **plot_kwargs)
    module = module_string(module_file)

    def main(available_configs: Dict[str, Experiment], argv=None):
        return run_experiment_cli(module, available_configs, plot, argv)

    return main
