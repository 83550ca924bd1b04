"""Device-resident adapters of the tabular benchmarks (FCNet, HPOBench,
PD1) for lock-step campaigns (``scamlgp_tpu/benchmarking/tabular_adapters.py``).

A tabular benchmark evaluates a configuration by a table lookup, and on the
device that lookup is a few tensor operations, so a whole tabular BO
campaign runs as one lock-step campaign (``parallel/campaign.py``):

- **FCNet** and **HPOBench** tables cover a finite grid: integer bin
  arithmetic, then one gather from a per-study value table ``(S, G)``;
- **PD1** is an L1 nearest-neighbour lookup over the target task's rows: a
  masked distance ``(S, R, d)``, its argmin per study, and one gather.

The campaign's ``benchmark_fn`` is batched over studies,
``(x_unit (S, d), task_params) -> (S,)``, so both lookups are too: the
per-study tables ride in ``task_params`` with a leading study axis.
Meta-data, target tables and optima are prepared on the host from the
ordinary benchmark objects, so the campaign sees exactly the data the
sequential driver would.

Binning matches ``bo/space.py`` ``from_unit`` for ordinal, categorical and
integer dimensions (``clip(floor(u * n), 0, n - 1)``), so a grid campaign
observes what the host driver's propose -> ``from_numerical`` -> table
lookup would.  Continuous dimensions in grid mode are quantized to
``continuous_levels`` bin centres (an approximation: the published HPOBench
and FCNet spaces are fully discrete, so it matters only for synthetic
stand-ins).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from scamlgp_tpu_torch.bo.core import EvaluationSpecification
from scamlgp_tpu_torch.bo.space import (
    CategoricalParameter,
    ContinuousParameter,
    IntegerParameter,
    ParameterSpace,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import scamlgp as m


# --------------------------------------------------------------------------
# grid enumeration (host side)


def _free_params(space: ParameterSpace):
    return [p for p in space._params if p.name not in space.fixed]


def grid_levels(space: ParameterSpace, continuous_levels: int = 16
                ) -> List[List]:
    """Per free dimension, the list of representative parameter values:
    ordinal, categorical and integer levels verbatim; continuous dimensions
    quantized to ``continuous_levels`` bin centres through ``from_unit``."""
    levels = []
    for p in _free_params(space):
        if isinstance(p, CategoricalParameter):  # includes Ordinal
            levels.append(list(p.values))
        elif isinstance(p, IntegerParameter):
            levels.append(list(range(p.lower, p.upper + 1)))
        elif isinstance(p, ContinuousParameter):
            levels.append([p.from_unit((j + 0.5) / continuous_levels)
                           for j in range(continuous_levels)])
        else:
            raise NotImplementedError(
                f"Unsupported parameter type {type(p)} for device tables")
    return levels


def enumerate_grid_table(space: ParameterSpace, evaluate,
                         continuous_levels: int = 16) -> np.ndarray:
    """Evaluate ``evaluate(config) -> float`` on the full cartesian grid,
    flattened row-major in parameter order (first dimension slowest): the
    order ``make_grid_lut_fn`` indexes."""
    params = _free_params(space)
    levels = grid_levels(space, continuous_levels)
    fixed = dict(space.fixed)
    values = np.empty(int(np.prod([len(lv) for lv in levels])), np.float64)
    for row, combo in enumerate(itertools.product(*levels)):
        config = dict(zip((p.name for p in params), combo))
        config.update(fixed)
        values[row] = evaluate(config)
    return values


# --------------------------------------------------------------------------
# batched device lookups


def make_grid_lut_fn(n_levels: Sequence[int]):
    """``(x_unit (S, d), task_params) -> (S,)`` for row-major grid tables
    ``task_params["table"]`` of shape ``(S, G)``.

    Per dimension ``bin = clip(floor(u * n), 0, n - 1)``, the host codec's
    (``bo/space.py`` ``from_unit``); the row-major index of the bins picks
    each study's entry of its own table."""
    n_levels = tuple(int(n) for n in n_levels)

    def fn(x_unit, task_params):
        idx = torch.zeros(x_unit.shape[:-1], dtype=torch.long,
                          device=x_unit.device)
        for d, n in enumerate(n_levels):
            j = torch.floor(x_unit[..., d] * n).long().clamp(0, n - 1)
            idx = idx * n + j
        table = task_params["table"]
        return torch.gather(table, -1, idx[..., None])[..., 0]

    return fn


def make_nn_lut_fn(lower: Sequence[float], upper: Sequence[float]):
    """Batched L1 nearest-neighbour lookup (PD1's semantics, the reference's
    ``pd1.py:103-111``): map each study's unit point to parameter space by
    the per-dimension affine ``lo + (hi - lo) * u``, take the closest row
    of its ``task_params["coords"]`` ``(S, R, d)`` by L1 distance (padded
    rows masked out by ``task_params["valid"]`` ``(S, R)``), and return
    that row's ``task_params["values"]`` ``(S, R)`` entry, ``(S,)``."""
    lo = torch.as_tensor(np.asarray(lower, np.float64))
    span = torch.as_tensor(np.asarray(upper, np.float64)) - lo

    def fn(x_unit, task_params):
        xv = (lo.to(x_unit) + span.to(x_unit) * x_unit.clamp(0.0, 1.0))
        dist = (task_params["coords"] - xv[..., None, :]).abs().sum(-1)
        dist = torch.where(task_params["valid"], dist,
                           torch.full_like(dist, torch.inf))
        i = torch.argmin(dist, dim=-1)
        return torch.gather(task_params["values"], -1, i[..., None])[..., 0]

    return fn


# --------------------------------------------------------------------------
# campaign inputs (host side)


def _meta_task_data(benchmark, seed, dtype, device):
    """One study's meta-data, encoded as the sequential driver encodes it
    (sorted task order, unit-cube encoding)."""
    md = benchmark.get_meta_data(distribution="random", seed=seed)
    xs, ys = [], []
    name = benchmark.objectives[0].name
    for uid in sorted(md.keys(), key=str):
        evals = md[uid]
        X = np.stack([benchmark.search_space.to_numerical(e.configuration)
                      for e in evals])
        y = np.asarray([e.objectives[name] for e in evals])
        xs.append(X)
        ys.append(y)
    return m.pack_task_data(xs, ys, dtype=dtype, device=device)


def _stack_meta(task_data) -> m.TaskData:
    return m.TaskData(*[torch.stack(ls) for ls in zip(*task_data)])


def _evaluate_host(benchmark, config) -> float:
    ev = benchmark(EvaluationSpecification(configuration=config))
    return float(ev.objectives[benchmark.objectives[0].name])


def campaign_inputs_from_grid_tabular(benchmark_factory, study_seeds,
                                      continuous_levels: int = 16,
                                      dtype=torch.float32, device=None):
    """(benchmark_fn, task_params, meta TaskData, optima) for a batch of
    seeded studies of a grid-table benchmark (FCNet, HPOBench).

    ``benchmark_factory(seed)`` returns a fresh benchmark (the per-seed
    target-task draw happens inside, as in ``local_runner.run_study``).
    Each distinct target task's table is enumerated once on the host and
    shipped as the studies' rows of ``task_params["table"]`` ``(S, G)``;
    ``optima`` is a float64 numpy array ``(S,)``.  Tensors go to
    ``device`` (``cuda`` when left out).
    """
    device = resolve_device(device)
    tables: Dict[str, np.ndarray] = {}
    rows, task_data, optima = [], [], []
    n_levels = None
    for seed in study_seeds:
        b = benchmark_factory(seed)
        lv = grid_levels(b.search_space, continuous_levels)
        if n_levels is None:
            n_levels = [len(x) for x in lv]
        tt = getattr(getattr(b, "target_task", None), "uid", "target")
        cache_key = str(tt)
        if cache_key not in tables:
            tables[cache_key] = enumerate_grid_table(
                b.search_space, lambda cfg: _evaluate_host(b, cfg),
                continuous_levels)
        rows.append(tables[cache_key])
        task_data.append(_meta_task_data(b, seed, dtype, device))
        optima.append(float(b.optimum))

    fn = make_grid_lut_fn(n_levels)
    task_params = {"table": torch.as_tensor(np.stack(rows), dtype=dtype,
                                            device=device)}
    return fn, task_params, _stack_meta(task_data), np.asarray(optima)


def campaign_inputs_from_pd1(benchmark_factory, study_seeds,
                             dtype=torch.float32, device=None):
    """(benchmark_fn, task_params, meta TaskData, optima) for PD1 studies:
    each study's target-task rows (``PD1.task_rows``: configuration coords
    and objective values), padded to the widest task, for the batched
    nearest-neighbour lookup: ``coords`` ``(S, R, d)``, ``values``
    ``(S, R)`` and the bool mask ``valid`` ``(S, R)``."""
    device = resolve_device(device)
    coords_list, values_list, task_data, optima = [], [], [], []
    space = None
    for seed in study_seeds:
        b = benchmark_factory(seed)
        space = b.search_space
        c, v = b.task_rows()
        coords_list.append(c)
        values_list.append(v)
        task_data.append(_meta_task_data(b, seed, dtype, device))
        optima.append(float(b.optimum))

    params = _free_params(space)
    for p in params:
        if not isinstance(p, ContinuousParameter) or p.transformation:
            raise NotImplementedError(
                "PD1 device adapter expects plain continuous dims")
    n_max = max(len(v) for v in values_list)
    S = len(values_list)
    d = len(params)
    coords = np.zeros((S, n_max, d))
    values = np.zeros((S, n_max))
    valid = np.zeros((S, n_max), bool)
    for i, (c, v) in enumerate(zip(coords_list, values_list)):
        coords[i, :len(v)] = c
        values[i, :len(v)] = v
        valid[i, :len(v)] = True

    fn = make_nn_lut_fn([p.lower for p in params], [p.upper for p in params])
    task_params = {"coords": torch.as_tensor(coords, dtype=dtype,
                                             device=device),
                   "values": torch.as_tensor(values, dtype=dtype,
                                             device=device),
                   "valid": torch.as_tensor(valid, device=device)}
    return fn, task_params, _stack_meta(task_data), np.asarray(optima)
