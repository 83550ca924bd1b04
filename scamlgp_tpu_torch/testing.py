"""Importable optimizer-conformance tests (the port's copy of
``scamlgp_tpu/testing.py``, on the port's datatypes).

Native re-host of the reference's ``scamlgp/testing.py`` (the
shuffled-meta-data determinism contract, ``testing.py:18-103``) plus the
relevant blackboxopt reference-test semantics the reference imports from its
dependency (``tests/optimizer_test.py:25-53``): sequential optimization,
determinism under shuffled evaluation reporting, fixed parameters,
conditional spaces, and missing-objective handling.

Any optimizer exposing the ``generate_evaluation_specification`` / ``report``
surface can be run through these.
"""

from __future__ import annotations

import random
from typing import Type

import numpy as np

from scamlgp_tpu_torch.bo.core import Evaluation, Objective
from scamlgp_tpu_torch.bo.space import (
    CategoricalParameter,
    ContinuousParameter,
    ParameterSpace,
)

#: 1-D meta-data fixture (reference ``testing.py:18-28``).
META_DATA_1D = {
    "task_1": [
        Evaluation(configuration={"x0": 0.8}, objectives={"loss": -6.07}),
        Evaluation(configuration={"x0": 1.49}, objectives={"loss": -18.6}),
        Evaluation(configuration={"x0": 1.56}, objectives={"loss": -19.9}),
        Evaluation(configuration={"x0": 2.5}, objectives={"loss": -33.2}),
        Evaluation(configuration={"x0": 3.0}, objectives={"loss": -29.2}),
        Evaluation(configuration={"x0": 1.2}, objectives={"loss": -31.1}),
        Evaluation(configuration={"x0": 2.7}, objectives={"loss": -30.2}),
    ]
}


def _run_experiment_1d_deterministic(x0):
    """Cheap deterministic quartic (reference ``testing.py:31-35``)."""
    params = np.array([0.75, 0.0, -10.0, 0.0, 0.0])
    return float(np.polyval(params, np.atleast_1d(x0))[0])


def _run_optimizer(optimizer, steps=5):
    evaluations = []
    for _ in range(steps):
        es = optimizer.generate_evaluation_specification()
        evaluation = es.create_evaluation(
            objectives={"loss": _run_experiment_1d_deterministic(
                **es.configuration)})
        optimizer.report(evaluation)
        evaluations.append(evaluation)
    return evaluations


def _space_1d(seed):
    space = ParameterSpace()
    space.add(ContinuousParameter("x0", (0.5, 3)))
    space.seed(seed)
    return space


def is_deterministic_with_shuffled_meta_data(optimizer_class: Type,
                                             optimizer_kwargs: dict,
                                             seed: int):
    """Same meta-data in shuffled orders -> identical proposals; different
    meta-data -> different proposals (reference ``testing.py:50-100``)."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs["objective"] = Objective("loss", False)

    test_runs = []
    for _ in range(2):
        shuffled_data = {k: list(v) for k, v in META_DATA_1D.items()}
        for evals in shuffled_data.values():
            random.shuffle(evals)
        optimizer_kwargs["meta_data"] = shuffled_data
        optimizer = optimizer_class(_space_1d(seed), seed=seed,
                                    **optimizer_kwargs)
        test_runs.append(_run_optimizer(optimizer))

    optimizer_kwargs["meta_data"] = {
        "task_1": [Evaluation(configuration={"x0": 0.55},
                              objectives={"loss": -4.07})]
    }
    optimizer = optimizer_class(_space_1d(seed), seed=seed, **optimizer_kwargs)
    evals_other_metadata = _run_optimizer(optimizer)

    x0s_other = [e.configuration["x0"] for e in evals_other_metadata]
    x0s_1 = [e.configuration["x0"] for e in test_runs[0]]
    x0s_2 = [e.configuration["x0"] for e in test_runs[1]]

    assert set(x0s_1) == set(x0s_2)
    assert set(x0s_other) != set(x0s_2)


def optimizes_toy_problem(optimizer_class: Type, optimizer_kwargs: dict,
                          seed: int, steps: int = 6):
    """Sequential generate/evaluate/report runs and improves the incumbent."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs.setdefault("objective", Objective("loss", False))
    optimizer = optimizer_class(_space_1d(seed), seed=seed, **optimizer_kwargs)
    evals = _run_optimizer(optimizer, steps=steps)
    assert len(evals) == steps
    losses = [e.objectives["loss"] for e in evals]
    assert all(np.isfinite(losses))
    assert min(losses) <= losses[0]


def respects_fixed_parameter(optimizer_class: Type, optimizer_kwargs: dict,
                             seed: int):
    """Fixed parameters always appear with their fixed value."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs.setdefault("objective", Objective("loss", False))
    space = ParameterSpace()
    space.add(ContinuousParameter("x0", (0.5, 3)))
    space.add(ContinuousParameter("x1", (-1.0, 1.0)))
    space.fix(x1=0.25)
    space.seed(seed)
    if "meta_data" in optimizer_kwargs:
        optimizer_kwargs["meta_data"] = {
            "task_1": [
                Evaluation(configuration={"x0": c["x0"], "x1": 0.25},
                           objectives=c["objectives"])
                for c in (
                    {"x0": 0.8, "objectives": {"loss": -6.07}},
                    {"x0": 1.49, "objectives": {"loss": -18.6}},
                    {"x0": 2.5, "objectives": {"loss": -33.2}},
                    {"x0": 3.0, "objectives": {"loss": -29.2}},
                )
            ]
        }
    optimizer = optimizer_class(space, seed=seed, **optimizer_kwargs)
    for _ in range(3):
        es = optimizer.generate_evaluation_specification()
        assert es.configuration["x1"] == 0.25
        optimizer.report(es.create_evaluation(
            objectives={"loss": _run_experiment_1d_deterministic(
                es.configuration["x0"])}))


def handles_conditional_space(optimizer_class: Type, optimizer_kwargs: dict,
                              seed: int):
    """Conditional parameters: inactive dims are imputed, proposals valid."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs.setdefault("objective", Objective("loss", False))
    space = ParameterSpace()
    space.add(CategoricalParameter("method", ["a", "b"]))
    space.add(ContinuousParameter("x0", (0.5, 3)),
              condition=lambda method: method == "a")
    space.add(ContinuousParameter("x1", (0.0, 1.0)),
              condition=lambda method: method == "b")
    space.seed(seed)

    def evaluate(config):
        if config["method"] == "a":
            return _run_experiment_1d_deterministic(config["x0"])
        return float(config["x1"] - 0.5)

    if "meta_data" in optimizer_kwargs:
        rng = np.random.default_rng(seed)
        evals = []
        for _ in range(6):
            c = space.sample(rng)
            evals.append(Evaluation(configuration=c,
                                    objectives={"loss": evaluate(c)}))
        optimizer_kwargs["meta_data"] = {"task_1": evals}
    optimizer = optimizer_class(space, seed=seed, **optimizer_kwargs)
    for _ in range(4):
        es = optimizer.generate_evaluation_specification()
        assert space.check_validity(es.configuration)
        optimizer.report(es.create_evaluation(
            objectives={"loss": evaluate(es.configuration)}))


def handles_missing_objective_values(optimizer_class: Type,
                                     optimizer_kwargs: dict, seed: int):
    """None objectives are tolerated and excluded from the fit
    (reference ``tests/optimizer_test.py:56-97``)."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs.setdefault("objective", Objective("loss", False))
    optimizer = optimizer_class(_space_1d(seed), seed=seed, **optimizer_kwargs)
    for i in range(4):
        es = optimizer.generate_evaluation_specification()
        loss = (None if i == 1
                else _run_experiment_1d_deterministic(**es.configuration))
        optimizer.report(es.create_evaluation(objectives={"loss": loss}))
    assert len(optimizer.X) == 4
    assert sum(np.isfinite(optimizer.losses)) == 3


def is_deterministic_when_reporting_shuffled_evaluations(
        optimizer_class: Type, optimizer_kwargs: dict, seed: int):
    """Two optimizers fed the same batch of evaluations in different orders
    must propose the same next configuration (blackboxopt reference-test
    semantics — the internal fit data is canonically sorted)."""
    optimizer_kwargs = dict(optimizer_kwargs)
    optimizer_kwargs["objective"] = Objective("loss", False)

    rng = np.random.default_rng(seed)
    evals = []
    for _ in range(5):
        x0 = float(rng.uniform(0.5, 3.0))
        evals.append(Evaluation(
            configuration={"x0": x0},
            objectives={"loss": _run_experiment_1d_deterministic(x0)}))

    proposals = []
    for order in (evals, list(reversed(evals))):
        optimizer = optimizer_class(_space_1d(seed), seed=seed,
                                    **optimizer_kwargs)
        optimizer.report(list(order))
        es = optimizer.generate_evaluation_specification()
        proposals.append(es.configuration["x0"])
    assert proposals[0] == proposals[1]


#: Blackboxopt-style reference tests (semantics of the dependency's suite).
ALL_REFERENCE_TESTS = [
    optimizes_toy_problem,
    respects_fixed_parameter,
    handles_conditional_space,
    handles_missing_objective_values,
    is_deterministic_when_reporting_shuffled_evaluations,
]

#: Reference's own additional suite (``testing.py:103``).
META_OPTIMIZER_REFERENCE_TESTS = [is_deterministic_with_shuffled_meta_data]
