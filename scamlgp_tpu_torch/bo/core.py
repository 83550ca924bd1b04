"""Core blackbox-optimization datatypes and the sequential loop.

The reference builds on the external ``blackboxopt`` package for these
(``Evaluation`` / ``EvaluationSpecification`` / ``Objective``,
``sort_evaluations``, ``sequential.run_optimization_loop`` — see
``reference optimizer.py:9-12`` and
``benchmarking/bbo_helper.py:84-88``).  This engine hosts them natively so the
framework is standalone.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from typing import Any, Dict, Iterable, List, Optional, Union


@dataclasses.dataclass
class Objective:
    """An objective with a name and optimization direction."""

    name: str
    greater_is_better: bool = False


@dataclasses.dataclass
class EvaluationSpecification:
    """A configuration to evaluate, plus run metadata."""

    configuration: Dict[str, Any]
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    context: Optional[Dict[str, Any]] = None
    optional_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    created_unixtime: Optional[float] = None

    def __post_init__(self):
        if self.created_unixtime is None:
            self.created_unixtime = datetime.datetime.now().timestamp()

    def create_evaluation(self, objectives: Dict[str, Optional[float]],
                          user_info: Optional[Dict[str, Any]] = None,
                          **kwargs) -> "Evaluation":
        return Evaluation(
            configuration=dict(self.configuration),
            settings=dict(self.settings),
            context=None if self.context is None else dict(self.context),
            optional_info=dict(self.optional_info),
            created_unixtime=self.created_unixtime,
            objectives=dict(objectives),
            user_info=user_info,
            **kwargs,
        )


@dataclasses.dataclass
class Evaluation(EvaluationSpecification):
    """An evaluated configuration; ``None`` objectives mean 'unknown'."""

    objectives: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict)
    user_info: Optional[Dict[str, Any]] = None
    finished_unixtime: Optional[float] = None

    def __post_init__(self):
        super().__post_init__()
        if self.finished_unixtime is None:
            self.finished_unixtime = datetime.datetime.now().timestamp()


def _canonical_key(e: Union[Evaluation, EvaluationSpecification]) -> str:
    """Order-independent canonical identity of an evaluation (configuration +
    objectives), used for deterministic sorting."""
    payload = {
        "configuration": e.configuration,
        "objectives": getattr(e, "objectives", None),
        "settings": e.settings,
        "context": e.context,
    }
    return json.dumps(payload, sort_keys=True, default=str)


def sort_evaluations(evaluations: Iterable[Evaluation]) -> List[Evaluation]:
    """Deterministic ordering regardless of input order — the contract that
    makes runs reproducible under shuffled meta-data
    (``reference utils.py:84-87``, tested by
    ``testing.py:50-100``)."""
    return sorted(evaluations, key=_canonical_key)


class OptimizerError(RuntimeError):
    pass


class ObjectivesError(ValueError):
    pass


class OptimizationComplete(Exception):
    """Raised by an optimizer that has exhausted its budget."""


class EvaluationsError(ValueError):
    def __init__(self, message: str, evaluations=None):
        super().__init__(message)
        self.evaluations = evaluations or []


def run_optimization_loop(optimizer, evaluation_function, max_evaluations: int,
                          catch_exceptions_from_evaluation_function: bool = False
                          ) -> List[Evaluation]:
    """Sequential generate -> evaluate -> report loop (the semantics of
    blackboxopt ``sequential.run_optimization_loop`` used by
    ``reference benchmarking/bbo_helper.py:84-88``)."""
    evaluations: List[Evaluation] = []
    for _ in range(max_evaluations):
        try:
            es = optimizer.generate_evaluation_specification()
        except OptimizationComplete:
            break
        try:
            evaluation = evaluation_function(es)
        except Exception:
            if not catch_exceptions_from_evaluation_function:
                raise
            evaluation = es.create_evaluation(
                objectives={o.name: None for o in
                            getattr(optimizer, "objectives",
                                    [optimizer.objective])})
        optimizer.report(evaluation)
        evaluations.append(evaluation)
    return evaluations
