"""Meta-learning Bayesian-optimization driver, the public API
(``scamlgp_tpu/bo/optimizer.py``, MAP mode).

``ScaMLGPBO`` is the reference's sequential driver (its ``optimizer.py:27-185``)
with the generate/report surface of blackboxopt's single-objective base
class: pending-evaluation accounting, NaN-objective filtering and an initial
random design.  The meta-fit, every refit and every acquisition run as
batched torch on the driver's device.  The target model holds exactly the
observations it is fitted on: the JAX package pads them to power-of-two
capacities with masks only to bound its recompiles, and eager torch
compiles nothing.

Randomness comes from one CPU ``torch.Generator`` seeded with ``seed``
(0 when left out), drawn in the order in which the JAX driver splits its
key: the meta-fit's restart draws at construction (``meta_fit_scamlgp``),
then each proposal's Sobol seed (``_sobol_seed``) and each refit's restart
draws (``fit_scamlgp``) as the calls come.  A CPU generator gives the same
draws whichever device the driver runs on.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Union

import numpy as np
import torch

from scamlgp_tpu_torch.bo import acquisition as acq_lib
from scamlgp_tpu_torch.bo import optimize as acqopt
from scamlgp_tpu_torch.bo.core import (
    Evaluation,
    EvaluationSpecification,
    Objective,
    OptimizerError,
    sort_evaluations,
)
from scamlgp_tpu_torch.bo.space import ParameterSpace, impute_nans_with_constant
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp as gp_lib
from scamlgp_tpu_torch.models import scamlgp as model_lib
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


def metadata_to_numerical(meta_data: Dict[Hashable, Iterable[Evaluation]],
                          search_space: ParameterSpace, objective: Objective):
    """Sorted, unit-cube-encoded, NaN-imputed per-task arrays (the
    reference's ``utils.py:72-109``).  Y is loss-oriented: greater-is-better
    objectives are negated so that everything minimizes."""
    xs, ys, task_ids = [], [], []
    for task_id in sorted(meta_data.keys(), key=str):
        evals = sort_evaluations(meta_data[task_id])
        X = np.stack([
            impute_nans_with_constant(search_space.to_numerical(e.configuration))
            for e in evals])
        y = np.asarray([e.objectives[objective.name] for e in evals],
                       dtype=np.float64)
        if objective.greater_is_better:
            y = -y
        xs.append(X)
        ys.append(y)
        task_ids.append(task_id)
    return task_ids, xs, ys


def _acq_value(model: model_lib.ScaMLGP, source_cfg: gp_lib.GPConfig,
               target_cfg: gp_lib.GPConfig, af: acq_lib.AcquisitionFunction,
               state: model_lib.AcqState, best_f) -> Callable:
    """The acquisition value at points (Q, d) through the cached predictive
    state, built once per proposal (the JAX package's ``_acq_value``,
    ``optimizer.py:60``)."""

    def value(x):
        mean, var = model_lib.scamlgp_posterior_diag_cached(
            model, source_cfg, target_cfg, state, x, original_scale=True)
        return af(mean, var, best_f)

    return value


class SingleObjectiveOptimizer:
    """Minimal blackboxopt-compatible base (generate/report surface)."""

    def __init__(self, search_space: ParameterSpace, objective: Objective,
                 seed: Optional[int] = None):
        self.search_space = search_space.copy()
        self.objective = objective
        self.seed = seed
        if seed is not None:
            self.search_space.seed(seed)

    def generate_evaluation_specification(self) -> EvaluationSpecification:
        raise NotImplementedError

    def report(self, evaluations) -> None:
        raise NotImplementedError


class ScaMLGPBO(SingleObjectiveOptimizer):
    def __init__(
        self,
        search_space: ParameterSpace,
        objective: Objective,
        meta_data: Dict[Hashable, Iterable[Evaluation]],
        gp_likelihood=None,
        gp_kernel: Optional[gp_lib.GPConfig] = None,
        base_gp_kernel: Optional[gp_lib.GPConfig] = None,
        acquisition_function_factory: Optional[Callable] = None,
        af_optimizer_kwargs: Optional[dict] = None,
        num_initial_random_samples: int = 0,
        max_pending_evaluations: Optional[int] = 1,
        num_restarts_log_likelihood: int = 5,
        model_kwargs: Optional[Dict[str, Any]] = None,
        logger: Optional[logging.Logger] = None,
        seed: Optional[int] = None,
        dtype=None,
        num_fit_steps: int = 60,
        fit_method: str = "map",
        hmc_kwargs: Optional[Dict[str, Any]] = None,
        vi_kwargs: Optional[Dict[str, Any]] = None,
        device=None,
    ):
        r"""Single-objective meta-learning BO with ScaML-GP as surrogate.

        The reference's constructor contract (its ``optimizer.py:28-154``):
        converts the meta-data to numbers, meta-fits one source GP per task
        (one batched fit), builds the target model on empty data, and
        defaults the acquisition to UCB(beta=9) for minimization with no
        initial random design and one pending evaluation at a time.

        Args:
            search_space: the space to optimize over.
            objective: objective name + direction.
            meta_data: ``{task_id: [Evaluation, ...]}`` source observations.
            gp_likelihood: accepted for the reference's signature; unused.
            gp_kernel: target GP config (reference ``gp_kernel``).
            base_gp_kernel: source GP config (reference ``base_gp_kernel``).
            acquisition_function_factory: callable returning an
                ``AcquisitionFunction`` (defaults to UCB(9), minimize).
            af_optimizer_kwargs: settings of the multi-start acquisition
                ascent (raw_samples, num_restarts, num_steps, lr).
            num_initial_random_samples: size of the random initial design.
            max_pending_evaluations: max parallel proposals (1 = sequential).
            num_restarts_log_likelihood: prior-sampled restarts on top of the
                warm start for every (re)fit.
            seed: seeds the driver's one generator (module docstring).
            dtype: working dtype; ``None`` means float64.  The reference
                runs in float64 (its ``optimizer.py:46,116-118``); the JAX
                package drops to float32 only because the TPU emulates
                float64, and the card computes float64 natively.
            num_fit_steps: L-BFGS steps of every (re)fit.
            fit_method: ``"map"``, multi-restart MAP-II as the reference.
                ``"hmc"``, ``"nuts"`` and ``"vi"`` are not ported yet and
                raise ``NotImplementedError``.
            hmc_kwargs, vi_kwargs: accepted for the JAX package's signature.
            device: where the model lives and runs; ``cuda`` unless the
                caller names a device.
        """
        super().__init__(search_space, objective, seed)
        if fit_method in ("hmc", "nuts", "vi"):
            raise NotImplementedError(
                f"fit_method={fit_method!r} is not ported yet (ROADMAP.md, "
                "queue 1: posterior-marginalized fits); use 'map'")
        if fit_method != "map":
            raise ValueError(f"Unknown fit_method {fit_method!r}")
        self.fit_method = fit_method
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger("scamlgp_tpu_torch")
        self.dtype = torch.float64 if dtype is None else dtype
        self.num_initial_random = num_initial_random_samples
        self.max_pending_evaluations = max_pending_evaluations
        self.num_restarts_log_likelihood = num_restarts_log_likelihood
        self.num_fit_steps = num_fit_steps
        self.model_kwargs = model_kwargs or {}
        self.af_optimizer_kwargs = dict(af_optimizer_kwargs or {})
        self._af_factory = acquisition_function_factory
        self._n_features = len(self.search_space)

        self._generator = torch.Generator(device="cpu").manual_seed(
            0 if seed is None else seed)
        self._pending = 0
        self._num_generated = 0
        self.X: List[np.ndarray] = []       # numeric configs, arrival order
        self.losses: List[float] = []       # NaN = unknown objective

        # --- meta-fit ------------------------------------------------------
        self.source_cfg = base_gp_kernel or gp_lib.source_gp_config()
        self.target_cfg = gp_kernel or gp_lib.target_gp_config()
        task_ids, xs, ys = metadata_to_numerical(
            meta_data, self.search_space, objective)
        self.task_ids = task_ids
        with GLOBAL_TIMER("meta_fit", self.device):
            self.source_gps, _ = model_lib.meta_fit_scamlgp(
                xs, ys, self._generator, cfg=self.source_cfg,
                num_restarts_log_likelihood=num_restarts_log_likelihood,
                num_steps=num_fit_steps, dtype=self.dtype,
                device=self.device)

        # --- target model on empty data (optimizer.py:135-141) -------------
        self.model = self._build_model(
            np.zeros((0, self._n_features)), np.zeros((0,)), params=None)

    def _sobol_seed(self) -> int:
        """The seed of one proposal's Sobol raw samples."""
        return int(torch.randint(0, np.iinfo(np.int32).max, (),
                                 generator=self._generator))

    def _build_model(self, X: np.ndarray, y: np.ndarray,
                     params) -> model_lib.ScaMLGP:
        def tensor(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        return model_lib.build_scamlgp(
            self.source_gps, self.source_cfg, tensor(X), tensor(y),
            target_cfg=self.target_cfg, params=params, **self.model_kwargs)

    def _acquisition(self) -> acq_lib.AcquisitionFunction:
        if self._af_factory is None:
            return acq_lib.UpperConfidenceBound()
        af = self._af_factory
        return af() if isinstance(af, type) else af

    def _propose(self, sobol_seed: int) -> acqopt.AcqOptResult:
        """Maximize the acquisition over the current model: the cached
        predictive state, then the Sobol sweep and the multi-start ascent
        (stage ``acquisition``)."""
        finite = [l for l in self.losses if np.isfinite(l)]
        best_f = torch.as_tensor(min(finite) if finite else np.inf,
                                 dtype=self.dtype, device=self.device)
        with GLOBAL_TIMER("acquisition", self.device):
            state = model_lib.scamlgp_acq_state(
                self.model, self.source_cfg, self.target_cfg)
            value = _acq_value(self.model, self.source_cfg, self.target_cfg,
                               self._acquisition(), state, best_f)
            return acqopt.optimize_acqf(
                value, self._n_features, sobol_seed, dtype=self.dtype,
                device=self.device, **self.af_optimizer_kwargs)

    # ------------------------------------------------------------------
    def generate_evaluation_specification(self) -> EvaluationSpecification:
        """Propose the next configuration (reference call stack 3.2)."""
        if (self.max_pending_evaluations is not None
                and self._pending >= self.max_pending_evaluations):
            raise OptimizerError(
                f"Maximum number of pending evaluations "
                f"({self.max_pending_evaluations}) reached.")

        if len(self.X) < self.num_initial_random or self._n_features == 0:
            config = self.search_space.sample()
            optional_info = {"model_based_pick": False}
        else:
            res = self._propose(self._sobol_seed())
            vec = impute_nans_with_constant(
                res.x.detach().cpu().numpy().astype(np.float64))
            config = self.search_space.from_numerical(vec)
            optional_info = {"model_based_pick": True}

        self._pending += 1
        self._num_generated += 1
        return EvaluationSpecification(configuration=config,
                                       optional_info=optional_info)

    # ------------------------------------------------------------------
    def report(self, evaluations: Union[Evaluation, Iterable[Evaluation]]
               ) -> None:
        """Ingest observations and refit the target model (the reference's
        ``report``, ``optimizer.py:156-185``)."""
        _evals = (list(evaluations)
                  if isinstance(evaluations, (list, tuple)) else [evaluations])
        for e in _evals:
            vec = impute_nans_with_constant(
                self.search_space.to_numerical(e.configuration))
            val = e.objectives.get(self.objective.name)
            loss = np.nan if val is None else float(val)
            if self.objective.greater_is_better and np.isfinite(loss):
                loss = -loss
            self.X.append(vec)
            self.losses.append(loss)
            self._pending = max(0, self._pending - 1)

        if len(self.X) < self.num_initial_random:
            return

        # deterministic fit data regardless of report order
        order = sorted(range(len(self.X)),
                       key=lambda i: (self.X[i].tobytes(), self.losses[i]))
        X = np.stack([self.X[i] for i in order]) if self.X else np.zeros(
            (0, self._n_features))
        y = np.asarray([self.losses[i] for i in order])

        # filter unknown objectives (filter_y_nans, optimizer.py:171-174)
        keep = np.isfinite(y)
        if keep.sum() == 0:
            return
        Xf, yf = X[keep], y[keep]

        # warm start: the fitted kernel and noise, the weights back at 1/M,
        # as the reference rebuilds ScaMLGP (optimizer.py:176-183)
        m = self.model.num_tasks
        warm = model_lib.TargetParams(
            raw_weights=model_lib.weights_inverse(torch.full(
                (m,), 1.0 / m, dtype=self.dtype, device=self.device)),
            gp=self.model.params.gp)
        self.model = self._build_model(Xf, yf, params=warm)
        with GLOBAL_TIMER("refit", self.device):
            self.model = model_lib.fit_scamlgp(
                self.model, self.target_cfg, self._generator,
                num_restarts=self.num_restarts_log_likelihood,
                num_steps=self.num_fit_steps)

    # ------------------------------------------------------------------
    def predict(self, configurations: Iterable[Dict[str, Any]]):
        """Posterior (mean, std) of the loss at the given configurations, in
        the objective's original scale and direction."""
        X = np.stack([
            impute_nans_with_constant(self.search_space.to_numerical(c))
            for c in configurations])
        Xq = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        mean, var = model_lib.scamlgp_posterior_diag(
            self.model, self.source_cfg, self.target_cfg, Xq)
        mean = mean.detach().cpu().numpy()
        if self.objective.greater_is_better:
            mean = -mean
        return mean, np.sqrt(var.detach().cpu().numpy())
