"""Glue between benchmarks and optimizers (``scamlgp_tpu/benchmarking/
bbo_helper.py``, the reference's ``bbo_helper.py:14-90``): builds the
objective from the benchmark, injects ``meta_data`` iff the optimizer's
signature declares it, and runs the sequential optimization loop.

The JAX package also passes the evaluation budget as ``capacity_hint`` to
pre-compile the driver's buffer sizes; eager torch compiles nothing, and
the port's driver takes no such argument."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Type

from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base as BenchmarkBase
from scamlgp_tpu_torch.bo.core import Evaluation, Objective, run_optimization_loop


def _prep_objective(benchmark: BenchmarkBase) -> Objective:
    if hasattr(benchmark, "objectives"):
        return benchmark.objectives[0]
    return Objective("loss", greater_is_better=False)


def run_with_bbo(benchmark: BenchmarkBase, optimizer_cls: Type,
                 optimizer_kwargs_from_config: Dict[str, Any],
                 max_evaluations: int,
                 meta_data_seed: int) -> List[Evaluation]:
    """Run the generate/evaluate/report loop on the benchmark for
    ``max_evaluations`` steps (the reference's ``bbo_helper.py:60-90``)."""
    objective = _prep_objective(benchmark)
    optimizer_kwargs = dict(optimizer_kwargs_from_config)

    # meta-data injection by signature introspection (reference :72-75)
    if "meta_data" in inspect.signature(optimizer_cls).parameters.keys():
        optimizer_kwargs["meta_data"] = benchmark.get_meta_data(
            seed=meta_data_seed, distribution="random")

    optimizer = optimizer_cls(search_space=benchmark.search_space,
                              objective=objective, **optimizer_kwargs)
    return run_optimization_loop(optimizer=optimizer,
                                 evaluation_function=benchmark,
                                 max_evaluations=max_evaluations)
