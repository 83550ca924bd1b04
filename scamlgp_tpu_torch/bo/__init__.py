"""The sequential driver ``ScaMLGPBO``, acquisition functions, the
acquisition ascent and the host-side BO datatypes."""

from scamlgp_tpu_torch.bo.core import (
    Evaluation,
    EvaluationSpecification,
    Objective,
    run_optimization_loop,
    sort_evaluations,
)
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO, SingleObjectiveOptimizer
from scamlgp_tpu_torch.bo.space import (
    CategoricalParameter,
    ContinuousParameter,
    IntegerParameter,
    OrdinalParameter,
    ParameterSpace,
)

__all__ = [
    "Evaluation", "EvaluationSpecification", "Objective",
    "run_optimization_loop", "sort_evaluations", "ScaMLGPBO",
    "SingleObjectiveOptimizer", "CategoricalParameter",
    "ContinuousParameter", "IntegerParameter", "OrdinalParameter",
    "ParameterSpace",
]
