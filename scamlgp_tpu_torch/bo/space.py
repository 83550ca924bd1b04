"""Search spaces: typed parameters with unit-cube numerical encoding.

Native replacement for the ``parameterspace`` dependency the reference builds
on (``reference optimizer.py:7``, benchmark search spaces in
``benchmarking/benchmarks/*.py``).  Capabilities hosted here:

- continuous / integer / categorical / ordinal parameters,
- optional log-scale transformation for continuous/integer parameters,
- conditional parameters (active only when a predicate over previously added
  parameters holds) — inactive dimensions encode as NaN, which the model layer
  imputes with a constant (``reference utils.py:105-106``),
- fixed parameters (excluded from the numerical encoding),
- deterministic seeded sampling,
- ``to_numerical`` / ``from_numerical`` unit-cube codec used by both the BO
  loop and the benchmarks.
"""

from __future__ import annotations

import copy
import inspect
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Parameter:
    def __init__(self, name: str):
        self.name = name

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def to_unit(self, value) -> float:
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError

    def round(self, value):
        return value


class ContinuousParameter(Parameter):
    def __init__(self, name: str, bounds: Tuple[float, float],
                 transformation: Optional[str] = None):
        super().__init__(name)
        self.lower, self.upper = float(bounds[0]), float(bounds[1])
        if self.upper <= self.lower:
            raise ValueError(f"Invalid bounds for {name}: {bounds}")
        if transformation not in (None, "log"):
            raise ValueError(f"Unknown transformation {transformation!r}")
        self.transformation = transformation
        if transformation == "log" and self.lower <= 0:
            raise ValueError("log transformation requires positive bounds")

    def _fwd(self, v):
        return math.log(v) if self.transformation == "log" else v

    def _bwd(self, t):
        return math.exp(t) if self.transformation == "log" else t

    def sample(self, rng):
        return self.from_unit(float(rng.uniform()))

    def to_unit(self, value):
        lo, hi = self._fwd(self.lower), self._fwd(self.upper)
        return (self._fwd(float(value)) - lo) / (hi - lo)

    def from_unit(self, u):
        lo, hi = self._fwd(self.lower), self._fwd(self.upper)
        v = self._bwd(lo + (hi - lo) * min(max(float(u), 0.0), 1.0))
        return min(max(v, self.lower), self.upper)


class IntegerParameter(Parameter):
    def __init__(self, name: str, bounds: Tuple[int, int],
                 transformation: Optional[str] = None):
        super().__init__(name)
        self.lower, self.upper = int(bounds[0]), int(bounds[1])
        if self.upper < self.lower:
            raise ValueError(f"Invalid bounds for {name}: {bounds}")
        self.transformation = transformation

    @property
    def _n(self):
        return self.upper - self.lower + 1

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper + 1))

    def to_unit(self, value):
        return (int(value) - self.lower + 0.5) / self._n

    def from_unit(self, u):
        idx = min(int(min(max(float(u), 0.0), 1.0 - 1e-12) * self._n),
                  self._n - 1)
        return self.lower + idx


class CategoricalParameter(Parameter):
    def __init__(self, name: str, values: Sequence[Any]):
        super().__init__(name)
        self.values = list(values)
        if not self.values:
            raise ValueError(f"Empty categorical {name}")

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def to_unit(self, value):
        idx = self.values.index(value)
        return (idx + 0.5) / len(self.values)

    def from_unit(self, u):
        n = len(self.values)
        idx = min(int(min(max(float(u), 0.0), 1.0 - 1e-12) * n), n - 1)
        return self.values[idx]


class OrdinalParameter(CategoricalParameter):
    """Ordered categorical — same codec, ordered semantics."""


Condition = Optional[Callable[..., bool]]


class ParameterSpace:
    """An ordered collection of (possibly conditional) parameters."""

    def __init__(self):
        self._params: List[Parameter] = []
        self._conditions: Dict[str, Condition] = {}
        self._fixed: Dict[str, Any] = {}
        self._rng = np.random.default_rng()

    # -- construction -----------------------------------------------------
    def add(self, parameter: Parameter, condition: Condition = None):
        if any(p.name == parameter.name for p in self._params):
            raise ValueError(f"Duplicate parameter {parameter.name}")
        self._params.append(parameter)
        self._conditions[parameter.name] = condition
        return self

    def fix(self, **fixed: Any):
        for name, value in fixed.items():
            param = self._get(name)
            if isinstance(param, (CategoricalParameter, OrdinalParameter)):
                if value not in param.values:
                    raise ValueError(f"{value!r} invalid for {name}")
            self._fixed[name] = value

    def copy(self) -> "ParameterSpace":
        return copy.deepcopy(self)

    def seed(self, seed) -> None:
        self._rng = np.random.default_rng(seed)

    # -- introspection ----------------------------------------------------
    def _get(self, name: str) -> Parameter:
        for p in self._params:
            if p.name == name:
                return p
        raise KeyError(name)

    def get_parameter_names(self) -> List[str]:
        return [p.name for p in self._params if p.name not in self._fixed]

    def __len__(self) -> int:
        """Number of dimensions in the numerical encoding (fixed excluded)."""
        return len(self.get_parameter_names())

    def __contains__(self, name: str) -> bool:
        return any(p.name == name for p in self._params)

    @property
    def fixed(self) -> Dict[str, Any]:
        return dict(self._fixed)

    def has_conditions(self) -> bool:
        return any(c is not None for c in self._conditions.values())

    def get_continuous_bounds(self) -> List[Tuple[float, float]]:
        bounds = []
        for p in self._params:
            if p.name in self._fixed:
                continue
            if not isinstance(p, ContinuousParameter):
                raise ValueError(
                    "get_continuous_bounds requires a purely continuous space")
            bounds.append((p.lower, p.upper))
        return bounds

    # -- conditions -------------------------------------------------------
    def _is_active(self, param: Parameter, config: Dict[str, Any]) -> bool:
        cond = self._conditions.get(param.name)
        if cond is None:
            return True
        arg_names = list(inspect.signature(cond).parameters)
        kwargs = {}
        for a in arg_names:
            if a not in config:
                return False
            kwargs[a] = config[a]
        return bool(cond(**kwargs))

    # -- sampling / codec -------------------------------------------------
    def sample(self, rng: Optional[np.random.Generator] = None
               ) -> Dict[str, Any]:
        rng = self._rng if rng is None else rng
        config: Dict[str, Any] = {}
        for p in self._params:
            if p.name in self._fixed:
                config[p.name] = self._fixed[p.name]
                continue
            if self._is_active(p, config):
                config[p.name] = p.sample(rng)
        return config

    def to_numerical(self, configuration: Dict[str, Any]) -> np.ndarray:
        """Encode into [0,1]^d; inactive conditional dims -> NaN."""
        vec = []
        for p in self._params:
            if p.name in self._fixed:
                continue
            if p.name in configuration and self._is_active(p, configuration):
                vec.append(p.to_unit(configuration[p.name]))
            else:
                vec.append(float("nan"))
        return np.asarray(vec, dtype=np.float64)

    def from_numerical(self, vector) -> Dict[str, Any]:
        vector = np.asarray(vector, dtype=np.float64).reshape(-1)
        names = self.get_parameter_names()
        if vector.shape[0] != len(names):
            raise ValueError(
                f"Expected vector of length {len(names)}, got {vector.shape[0]}")
        config: Dict[str, Any] = {}
        i = 0
        for p in self._params:
            if p.name in self._fixed:
                config[p.name] = self._fixed[p.name]
                continue
            u = vector[i]
            i += 1
            if self._is_active(p, config) and np.isfinite(u):
                config[p.name] = p.from_unit(u)
        return config

    def check_validity(self, configuration: Dict[str, Any]) -> bool:
        try:
            active = {}
            for p in self._params:
                if p.name in self._fixed:
                    active[p.name] = self._fixed[p.name]
                    continue
                if self._is_active(p, active):
                    if p.name not in configuration:
                        return False
                    active[p.name] = configuration[p.name]
            return True
        except Exception:
            return False


#: Constant used to impute NaN dimensions of conditional spaces before handing
#: X to the GP (blackboxopt ``impute_nans_with_constant`` semantics,
#: ``reference utils.py:105-106``).
NAN_IMPUTE_CONSTANT = -1.0


def impute_nans_with_constant(x: np.ndarray,
                              c: float = NAN_IMPUTE_CONSTANT) -> np.ndarray:
    x = np.array(x, dtype=np.float64, copy=True)
    x[~np.isfinite(x)] = c
    return x
