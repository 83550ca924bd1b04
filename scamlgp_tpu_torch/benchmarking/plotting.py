"""Regret analytics and figure generation (``scamlgp_tpu/benchmarking/
plotting.py``, the reference's ``plotting.py:21-426``).

Behavioral contracts replicated: running-min simple regret vs a known optimum
with a negative-regret warning; preference for the ``"<obj> (noise free)"``
objective when present; median/quartile or mean+-SEM aggregation; log-scale
regret grids; and the average-cumulative-regret ablation summary over
num-meta-tasks / points-per-task with log-log errorbars.

The regret helpers (``compute_regrets``, ``_regret_curves``,
``_compute_average_cum_regret``, ``_compute_sem_cum_regret``) need numpy
and scipy only.  matplotlib (with the Agg backend) and pandas are imported
by the functions that draw, so the module imports where they are not
installed.
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, Iterable, List, Optional, Tuple, Union
from warnings import warn

import numpy as np
from scipy.stats import sem

from scamlgp_tpu_torch.benchmarking.experiment_config_utils import (
    Experiment,
    parse_experiment_config,
    qualified_name,
)
from scamlgp_tpu_torch.bo.core import Objective


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def compute_regrets(objective: Objective, optimum: float,
                    objective_values: List[dict]) -> List[float]:
    """Running-min simple regret per BO iteration (behavioral contract of
    reference ``plotting.py:21-53``, vectorized over the iteration axis).

    Maximization objectives are folded into minimization by sign flip, so
    regret is always "distance above the optimum".  A slightly negative raw
    regret is possible when the recorded optimum itself came from a
    numerical optimizer (SHGO / device polish) — it is reported, not
    clamped.
    """
    sign = -1.0 if objective.greater_is_better else 1.0
    losses = sign * np.array([ov[objective.name] for ov in objective_values],
                             dtype=float)
    raw = losses - sign * float(optimum)
    if raw.size and raw.min() < -1e-6:
        warnings.warn(
            f"negative regret (min {raw.min():.6g}): an evaluation beat the "
            f"recorded optimum — optimum is likely numerical, not exact",
            Warning)
    return np.minimum.accumulate(raw).tolist()


def _study_objective(s: dict) -> Objective:
    """Prefer the noise-free objective variant when recorded
    (reference ``plotting.py:60-67``)."""
    base = s["objectives"][0]
    noise_free_name = base["name"] + " (noise free)"
    if noise_free_name in s["evaluations"][0]["objectives"].keys():
        return Objective(name=noise_free_name,
                         greater_is_better=base["greater_is_better"])
    return Objective(**base)




def _aggregate(values: np.ndarray, robust_statistics: bool):
    if robust_statistics:
        center = np.median(values, axis=0).squeeze()
        upper = np.quantile(values, 0.75, axis=0)
        lower = np.quantile(values, 0.25, axis=0)
    else:
        center = np.mean(values, axis=0).squeeze()
        s = sem(values, axis=0).squeeze()
        upper, lower = center + s, center - s
    return center, lower, upper


def _regret_curves(studies: list, optimum_override=None) -> np.ndarray:
    """(studies, iterations) matrix of running-min regrets.

    ``optimum_override`` replaces each study's recorded optimum: a scalar
    applies to every study, a sequence is indexed per study (the
    study-wise-best fallback of ``_study_wise_optima``).
    """
    def optimum_for(i, s):
        if optimum_override is None:
            return s["optimum"]
        if isinstance(optimum_override, Iterable):
            return optimum_override[i]
        return optimum_override

    return np.array([
        compute_regrets(_study_objective(s), optimum_for(i, s),
                        [e["objectives"] for e in s["evaluations"]])
        for i, s in enumerate(studies)])


def _cummin_objective_curves(studies: list,
                             objective: Objective) -> np.ndarray:
    """(studies, iterations) best-so-far objective values (no optimum)."""
    vals = np.array([[e["objectives"][objective.name]
                      for e in s["evaluations"]] for s in studies])
    acc = np.maximum if objective.greater_is_better else np.minimum
    return acc.accumulate(vals, axis=1) if vals.size else vals


def _banded_curve(ax, curves: np.ndarray, *, color, linestyle,
                  label, robust_statistics: bool):
    """Center line + dispersion band over the study axis of ``curves``."""
    if not len(curves):
        warn(f"no curves to plot for {label}")
        return
    iters = np.arange(1, curves.shape[1] + 1)
    center, lower, upper = _aggregate(np.asarray(curves), robust_statistics)
    ax.plot(iters, center, color=(*color, 0.8), linestyle=linestyle,
            label=label)
    ax.fill_between(iters, lower, upper, color=(*color, 0.3))
    ax.set_xlim(1, iters[-1])


def _study_wise_optima(data: List[dict], objective: Objective) -> List[float]:
    """Best observed value per study index across all runs (used when no
    benchmark optimum is available — reference ``plotting.py:188-205``)."""
    optima = []
    max_n_studies = max(len(d["studies"]) for d in data)
    min_or_max = max if objective.greater_is_better else min
    for i_study in range(max_n_studies):
        optima.append(min_or_max(
            min_or_max(e["objectives"][objective.name]
                       for e in d["studies"][i_study]["evaluations"])
            for d in data if i_study < len(d["studies"])))
    return optima


def grouped_results(runs_data: list, optimizer_styles: dict,
                    groups: Dict[str, Iterable[Experiment]],
                    robust_statistics: bool,
                    objective: Union[Objective, List[Objective]],
                    optimum: Optional[float] = None,
                    use_regrets: bool = True,
                    use_benchmark_optimum: bool = True,
                    rel_fig_width: float = 1.0, fig_height: float = 4.0,
                    x_limits: Optional[List[Tuple[int, int]]] = None,
                    y_limits: Optional[List[Tuple[float, float]]] = None,
                    n_rows: Optional[int] = None,
                    n_cols: Optional[int] = None, sharey: str = "none",
                    h_pad: float = 1.8):
    """Grid of per-group regret (or best-objective) curves, one style per
    optimizer (reference ``plotting.py:208-336``); returns the figure."""
    plt = _pyplot()
    plt.rc("font", family="serif")
    if n_rows is None:
        n_rows = 2
    if n_cols is None:
        n_cols = int(np.ceil(len(groups) / n_rows))
    fig, axs = plt.subplots(min(n_rows, len(groups)), n_cols,
                            figsize=(6.75 * rel_fig_width, fig_height),
                            sharex="col", sharey=sharey)
    if not isinstance(axs, Iterable):
        axs = np.array([axs])

    run_configs = [Experiment(**run["experiment_config"])
                   for run in runs_data]
    _objective = objective
    for i, ((title, group), ax) in enumerate(zip(groups.items(),
                                                 np.asarray(axs).flatten())):
        ax.set_title(title)
        _objective = objective[i] if isinstance(objective, list) else objective
        study_wise_optima = (
            _study_wise_optima(
                [runs_data[run_configs.index(config)] for config in group],
                _objective)
            if use_regrets and not use_benchmark_optimum else [])

        for config in group:
            try:
                i_config = run_configs.index(config)
            except ValueError:
                print("Unable to find configuration in available results, "
                      "skipping",
                      json.dumps(parse_experiment_config(config.__dict__),
                                 indent=2))
                continue
            data = runs_data[i_config]
            optimizer_style = (
                optimizer_styles[config.optimizer["cls"]]
                if isinstance(config.optimizer, dict)
                else optimizer_styles[config.optimizer])

            if use_regrets:
                override = (study_wise_optima
                            if optimum is None and not use_benchmark_optimum
                            else optimum)
                curves = _regret_curves(data["studies"], override)
                label = optimizer_style["label"]
                ax.set_yscale("log")
            else:
                curves = _cummin_objective_curves(data["studies"], _objective)
                label = f"{optimizer_style['label']} (S{len(data['studies'])})"
            _banded_curve(ax, curves, color=optimizer_style["color"],
                          linestyle=optimizer_style["line"], label=label,
                          robust_statistics=robust_statistics)
        ax.set_xticks([1] + list(ax.get_xticks()[1:]))

    y_label = "Regret" if use_regrets else _objective.name
    axs = np.asarray(axs)
    if axs.ndim == 2:
        for ax in axs[:, 0]:
            ax.set_ylabel(y_label)
        for ax in axs[-1, :]:
            ax.set_xlabel("Iteration")
    elif axs.ndim == 1:
        axs[0].set_ylabel(y_label)
        for ax in axs:
            ax.set_xlabel("Iteration")
    else:
        raise ValueError(f"Incompatible axis shape {axs.shape}")

    handles, labels = [], []
    for ax in axs.flatten():
        handle, label = ax.get_legend_handles_labels()
        handles.extend(handle)
        labels.extend(label)
    by_label = dict(zip(labels, handles))
    fig.legend(by_label.values(), by_label.keys(), loc="center right",
               ncol=1, labelspacing=1.5, frameon=False)
    for i, ax in enumerate(axs.flatten()):
        if x_limits is not None:
            ax.set_xlim(*x_limits[i])
        if y_limits is not None:
            ax.set_ylim(*y_limits[i])
    fig.tight_layout(h_pad=h_pad,
                     rect=(0.0, 0.0, 0.8 - 0.2 * (1 - rel_fig_width), 1))
    return fig


def _compute_average_cum_regret(studies: List[dict]) -> float:
    cum_regret = _regret_curves(studies).sum(axis=1).squeeze()
    return np.mean(cum_regret).item()


def _compute_sem_cum_regret(studies: List[dict]) -> float:
    cum_regret = _regret_curves(studies).sum(axis=1).squeeze()
    return np.sqrt(np.var(cum_regret) / cum_regret.shape[0]).item()


def plot_meta_data_summary_comparison(results: dict, styles: dict,
                                      ax,
                                      num_meta_tasks: Optional[int] = None,
                                      num_points_per_task: Optional[int] = None
                                      ):
    """Average cumulative regret +- SEM vs num-meta-tasks or points-per-task,
    log-log errorbars (reference ``plotting.py:351-426``)."""
    import pandas as pd

    assert (num_meta_tasks is None) != (num_points_per_task is None)
    _pyplot().rc("font", family="serif")

    _r = {k: v for k, v in results.items() if k != "environment"}
    df = pd.json_normalize(_r.values())
    df = df.assign(num_meta_tasks=df[
        "experiment_config.benchmark.kwargs.n_data_per_task"].map(len))
    df = df.assign(num_points_per_task=df[
        "experiment_config.benchmark.kwargs.n_data_per_task"].map(
            lambda x: x[0] if len(x) > 0 else 0))

    if "experiment_config.optimizer.cls" not in df.columns:
        df["experiment_config.optimizer.cls"] = None
    df["experiment_config.optimizer.cls"] = df[
        "experiment_config.optimizer.cls"].astype(object)
    _mask = df["experiment_config.optimizer.cls"].isna()
    df.loc[_mask, "experiment_config.optimizer.cls"] = df[
        "experiment_config.optimizer"][_mask]

    if num_meta_tasks is not None:
        df = df[(df["num_meta_tasks"] == num_meta_tasks)
                | (df["num_meta_tasks"] == 0)]
    if num_points_per_task is not None:
        df = df[(df["num_points_per_task"] == num_points_per_task)
                | (df["num_points_per_task"] == 0)]

    mode = ("num_points_per_task" if num_meta_tasks is not None
            else "num_meta_tasks")

    plot_data = []
    for x_value, group in df.groupby(mode):
        plot_data.extend([
            {mode: x_value, "average_cum_regret": avg, "sem_cum_regret": s,
             "experiment_config.optimizer.cls": cls}
            for avg, s, cls in zip(
                group["studies"].map(_compute_average_cum_regret),
                group["studies"].map(_compute_sem_cum_regret),
                group["experiment_config.optimizer.cls"])
        ])
    plot_df = pd.DataFrame(plot_data)
    plot_styles = {qualified_name(k.__module__, k.__name__): v
                   for k, v in styles.items()}
    for optimizer_cls, group in plot_df.groupby(
            "experiment_config.optimizer.cls"):
        ax.errorbar(group[mode], group["average_cum_regret"],
                    yerr=group["sem_cum_regret"], capsize=2,
                    ls=plot_styles[optimizer_cls]["line"],
                    color=plot_styles[optimizer_cls]["color"],
                    label=plot_styles[optimizer_cls]["label"])
    ax.set_xscale("log")
    ax.set_yscale("log")
