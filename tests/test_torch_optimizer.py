"""Port parity: the sequential driver ``ScaMLGPBO`` (``bo/optimizer.py``)
on the CPU in float64.

- The port's ``testing.py`` suite runs on the port's driver as
  ``tests/test_optimizer.py`` runs the JAX one, with the same fast
  settings, together with the counterparts of that file's driver tests.
- End to end, both drivers run the same loop for 4 steps, the port's with
  the JAX driver's random draws (its meta-fit restarts, each refit's
  restarts and each proposal's Sobol seed, made from the JAX key in the
  order in which the JAX driver splits it): the proposals agree to 1e-5 in
  the unit cube and the final ``predict`` to rtol 1e-6, the fits' L-BFGS
  amplifying roundoff over the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu import testing as jconf
from scamlgp_tpu.benchmarking.benchmarks import Branin as JBranin
from scamlgp_tpu.bo import optimizer as jopt
from scamlgp_tpu.bo.core import Objective as JObjective
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch import testing as conformance
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin as TBranin
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.acquisition import ExpectedImprovement
from scamlgp_tpu_torch.bo.core import (
    Evaluation,
    EvaluationSpecification,
    Objective,
    OptimizerError,
)
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm

FAST_KWARGS = dict(
    num_restarts_log_likelihood=2,
    num_fit_steps=30,
    af_optimizer_kwargs={"raw_samples": 256, "num_restarts": 4,
                         "num_steps": 25},
    device="cpu",
)


def space_1d():
    space = ParameterSpace()
    space.add(ContinuousParameter("x0", (0.5, 3)))
    return space


@pytest.mark.parametrize(
    "reference_test",
    conformance.ALL_REFERENCE_TESTS + conformance.META_OPTIMIZER_REFERENCE_TESTS,
    ids=lambda t: t.__name__)
def test_reference_suite(reference_test, seed):
    kwargs = dict(FAST_KWARGS)
    kwargs["meta_data"] = conformance.META_DATA_1D
    reference_test(ScaMLGPBO, kwargs, seed)


def test_max_pending_evaluations(seed):
    opt = ScaMLGPBO(space_1d(), Objective("loss", False),
                    conformance.META_DATA_1D, seed=seed, **FAST_KWARGS)
    opt.generate_evaluation_specification()
    with pytest.raises(OptimizerError, match="pending"):
        opt.generate_evaluation_specification()


def test_none_objective_keeps_all_evals_trains_on_subset(seed):
    opt = ScaMLGPBO(space_1d(), Objective("loss", False),
                    conformance.META_DATA_1D, seed=seed, **FAST_KWARGS)
    for i in range(5):
        es = opt.generate_evaluation_specification()
        loss = None if i == 2 else conformance._run_experiment_1d_deterministic(
            **es.configuration)
        opt.report(es.create_evaluation(objectives={"loss": loss}))
    assert len(opt.X) == 5
    assert int(opt.model.train_mask.sum()) == 4
    # the model holds the observations it is fitted on, and no padding
    assert opt.model.train_X.shape == (4, 1)


def test_expected_improvement_with_initial_random(seed):
    kwargs = dict(FAST_KWARGS)
    kwargs["acquisition_function_factory"] = ExpectedImprovement
    kwargs["num_initial_random_samples"] = 2
    opt = ScaMLGPBO(space_1d(), Objective("loss", False),
                    conformance.META_DATA_1D, seed=seed, **kwargs)
    losses = []
    for i in range(4):
        es = opt.generate_evaluation_specification()
        if i < 2:
            assert es.optional_info["model_based_pick"] is False
        loss = conformance._run_experiment_1d_deterministic(**es.configuration)
        losses.append(loss)
        opt.report(es.create_evaluation(objectives={"loss": loss}))
    assert all(np.isfinite(losses))


def test_greater_is_better_objective(seed):
    meta = {
        "t": [Evaluation(configuration={"x0": x},
                         objectives={"score": -conformance.
                                     _run_experiment_1d_deterministic(x)})
              for x in (0.8, 1.5, 2.2, 2.9)]
    }
    opt = ScaMLGPBO(space_1d(), Objective("score", True), meta, seed=seed,
                    **FAST_KWARGS)
    for _ in range(3):
        es = opt.generate_evaluation_specification()
        score = -conformance._run_experiment_1d_deterministic(
            **es.configuration)
        opt.report(es.create_evaluation(objectives={"score": score}))
    mean, std = opt.predict([{"x0": 1.56}])
    assert np.isfinite(mean[0]) and std[0] > 0


@pytest.mark.parametrize("fit_method", ["hmc", "nuts", "vi"])
def test_posterior_fit_methods_are_not_ported(fit_method):
    with pytest.raises(NotImplementedError, match="queue 1"):
        ScaMLGPBO(space_1d(), Objective("loss", False),
                  conformance.META_DATA_1D, fit_method=fit_method,
                  **FAST_KWARGS)
    with pytest.raises(ValueError, match="Unknown fit_method"):
        ScaMLGPBO(space_1d(), Objective("loss", False),
                  conformance.META_DATA_1D, fit_method="mcmc", **FAST_KWARGS)


def test_default_device_is_the_card():
    """Left out, the device is ``cuda``; without a CUDA device the driver
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    kwargs = dict(FAST_KWARGS)
    kwargs.pop("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScaMLGPBO(space_1d(), Objective("loss", False),
                  conformance.META_DATA_1D, **kwargs)


def test_float64_unless_asked():
    opt = ScaMLGPBO(space_1d(), Objective("loss", False),
                    conformance.META_DATA_1D, seed=1, **FAST_KWARGS)
    assert opt.dtype == torch.float64
    assert opt.source_gps.chol.dtype == torch.float64
    opt32 = ScaMLGPBO(space_1d(), Objective("loss", False),
                      conformance.META_DATA_1D, seed=1, dtype=torch.float32,
                      **FAST_KWARGS)
    assert opt32.model.train_X.dtype == torch.float32
    es = opt32.generate_evaluation_specification()
    assert 0.5 <= es.configuration["x0"] <= 3.0


def test_one_seed_one_study():
    """The driver's one generator: the same seed proposes the same, another
    seed does not."""
    def run(seed):
        opt = ScaMLGPBO(space_1d(), Objective("loss", False),
                        conformance.META_DATA_1D, seed=seed, **FAST_KWARGS)
        xs = []
        for _ in range(3):
            es = opt.generate_evaluation_specification()
            xs.append(es.configuration["x0"])
            opt.report(es.create_evaluation(objectives={
                "loss": conformance._run_experiment_1d_deterministic(
                    **es.configuration)}))
        return xs

    assert run(4) == run(4)
    assert run(4) != run(5)


# ---------------------------------------------------------------------------
# end to end against the JAX driver
# ---------------------------------------------------------------------------

class JaxDraws:
    """The JAX driver's draws from its key, in the order in which it splits
    the key, handed to the port's driver where it draws: its restart
    samplers (``gp.sample_params`` in the meta-fit, ``sample_target_params``
    in each refit) and its proposals' Sobol seed (``_sobol_seed``)."""

    def __init__(self, seed, monkeypatch):
        self.key = jax.random.PRNGKey(seed)
        monkeypatch.setattr(tgp, "sample_params", self.meta_fit)
        monkeypatch.setattr(tm, "sample_target_params", self.refit)
        monkeypatch.setattr(ScaMLGPBO, "_sobol_seed",
                            lambda drv: self.sobol_seed())

    def meta_fit(self, cfg, generator, d, dtype, batch_shape):
        num_tasks, restarts = batch_shape
        key_meta, self.key = jax.random.split(self.key)
        jcfg = jgp.source_gp_config()

        def task_draws(task_key):
            return jax.vmap(lambda k: jgp.sample_params(
                jcfg, k, d, jnp.float64))(jax.random.split(task_key,
                                                           restarts))

        sampled = jax.vmap(task_draws)(jax.random.split(key_meta, num_tasks))
        return convert.gp_params(convert.to_numpy_dict(sampled), device="cpu")

    def sobol_seed(self):
        self.key, k_af = jax.random.split(self.key)
        return int(jax.random.randint(k_af, (), 0, np.iinfo(np.int32).max))

    def refit(self, cfg, generator, num_tasks, d, dtype, batch_shape):
        (restarts,) = batch_shape
        self.key, k_fit = jax.random.split(self.key)
        keys = jax.random.split(k_fit, restarts)
        sampled = jax.vmap(lambda k: jm.sample_target_params(
            jgp.target_gp_config(), k, num_tasks, d, jnp.float64))(keys)
        return convert.target_params(convert.to_numpy_dict(sampled),
                                     device="cpu")


#: the Branin case's target functions: each is drawn as
#: ``Base.create_random_task`` draws the benchmark's target task, but from a
#: generator with this seed, so that each case drives both drivers on one
#: fixed function (the benchmark itself draws its target without a seed)
TARGET_SEEDS = (0, 1, 2, 3)


def make_case(case, target_seed=None):
    """(JAX space, objective, meta-data), (the port's), and the target
    function of the loop, a function of a configuration."""
    if case == "meta_data_1d":
        return ((jconf._space_1d(0), JObjective("loss", False),
                 jconf.META_DATA_1D),
                (conformance._space_1d(0), Objective("loss", False),
                 conformance.META_DATA_1D),
                lambda c: conformance._run_experiment_1d_deterministic(**c))
    jbench = JBranin(n_data_per_task=[6] * 3, seed=2)
    tbench = TBranin(n_data_per_task=[6] * 3, seed=2)
    task = TBranin.create_random_task(
        0, tbench._descriptors, tbench._settings, tbench._context,
        np.random.default_rng(target_seed))

    def evaluate(c):
        return tbench.function(**c, **task.descriptors, **task.settings,
                               **task.context)

    return ((jbench.search_space, JObjective("loss", False),
             jbench.get_meta_data(distribution="random", seed=2)),
            (tbench.search_space, Objective("loss", False),
             tbench.get_meta_data(distribution="random", seed=2)),
            evaluate)


def _drive(opt, space, evaluate, steps=4):
    xs = []
    for _ in range(steps):
        es = opt.generate_evaluation_specification()
        xs.append(space.to_numerical(es.configuration))
        opt.report(es.create_evaluation(
            objectives={"loss": evaluate(es.configuration)}))
    return np.stack(xs)


@pytest.mark.parametrize(
    "case, target_seed",
    [("meta_data_1d", None)]
    + [("branin_t3_p6", s) for s in TARGET_SEEDS],
    ids=["meta_data_1d"]
    + [f"branin_t3_p6_target{s}" for s in TARGET_SEEDS])
def test_driver_matches_the_jax_driver(case, target_seed, monkeypatch):
    seed = 11
    (jspace, jobj, jmeta), (tspace, tobj, tmeta), evaluate = make_case(
        case, target_seed)
    kwargs = {k: v for k, v in FAST_KWARGS.items() if k != "device"}
    jdrv = jopt.ScaMLGPBO(jspace, jobj, jmeta, seed=seed, **kwargs)
    JaxDraws(seed, monkeypatch)
    tdrv = ScaMLGPBO(tspace, tobj, tmeta, seed=seed, device="cpu", **kwargs)
    jx = _drive(jdrv, jdrv.search_space, evaluate)
    tx = _drive(tdrv, tdrv.search_space, evaluate)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    probe = [tdrv.search_space.from_numerical(v) for v in
             np.random.default_rng(0).uniform(size=(5, len(tx[0])))]
    jmean, jstd = jdrv.predict(probe)
    tmean, tstd = tdrv.predict(probe)
    np.testing.assert_allclose(tmean, jmean, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tstd, jstd, rtol=1e-6, atol=1e-9)
