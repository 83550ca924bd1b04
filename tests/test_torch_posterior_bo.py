"""The sequential driver ``ScaMLGPBO`` with posterior-marginalized fits
(``fit_method`` ``"hmc"``, ``"nuts"``, ``"vi"``), on the CPU in float64.

- Each method runs a short BO loop with small sampler settings (as
  ``tests/test_vi.py:223-261`` runs ``"vi"``) and exposes the mixture
  predictive through ``predict``.
- ``_refit``'s interleave and tail-anchored thinning of HMC chains equals
  the JAX driver's (``bo/optimizer.py:426-439``) on labelled samples, for
  several (draws, mixture size) pairs: both drivers' ``_refit`` run with
  their sampler replaced by one that returns the labels.
- After a posterior fit, ``predict`` equals the JAX driver's mixture
  predictive on the same model and draws (rtol 1e-10).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_posterior_case as case
from scamlgp_tpu import testing as jconf
from scamlgp_tpu.bo import optimizer as jopt
from scamlgp_tpu.bo.core import Objective as JObjective
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu_torch import testing as conformance
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo import optimizer as topt
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import hmc as thmc
from scamlgp_tpu_torch.models import scamlgp as tm
from tests.torch_threads import one_thread  # noqa: F401


SMALL = dict(
    hmc_kwargs={"num_chains": 2, "num_warmup": 8, "num_samples": 6,
                "num_leapfrog": 4, "max_depth": 3, "mixture_samples": 4},
    vi_kwargs={"num_steps": 20, "num_mc": 4, "mixture_samples": 4},
    num_restarts_log_likelihood=1, num_fit_steps=15,
    af_optimizer_kwargs={"raw_samples": 32, "num_restarts": 2,
                         "num_steps": 5},
    device="cpu")


def _drive(opt, steps=3):
    for _ in range(steps):
        es = opt.generate_evaluation_specification()
        opt.report(es.create_evaluation(objectives={
            "loss": conformance._run_experiment_1d_deterministic(
                **es.configuration)}))


@pytest.mark.parametrize("fit_method", ["hmc", "nuts", "vi"])
def test_driver_runs_posterior_fits(fit_method):
    opt = ScaMLGPBO(conformance._space_1d(0), Objective("loss", False),
                    conformance.META_DATA_1D, seed=0, fit_method=fit_method,
                    **SMALL)
    _drive(opt)
    samples = opt._hyper_samples
    assert samples.raw_weights.shape == (4, opt.model.num_tasks)
    # the last draw is the model's parameters
    assert torch.equal(opt.model.params.raw_weights, samples.raw_weights[-1])
    space = opt.search_space
    for x in opt.X:
        assert np.all((x >= 0) & (x <= 1))
    mean, std = opt.predict([{"x0": 1.0}, {"x0": 2.5}])
    assert np.isfinite(mean).all() and np.all(std >= 0.0)
    assert space.check_validity(
        opt.generate_evaluation_specification().configuration)


Model = collections.namedtuple("Model", ["params"])


@pytest.mark.parametrize("chains,samples,mixture", [
    (2, 4, 3), (2, 64, 16), (3, 5, 15), (3, 5, 40), (1, 7, 1), (4, 16, 8)])
def test_refit_thinning_matches_jax(chains, samples, mixture):
    """Labelled samples (chain c, sample s -> 1000 c + s) through both
    drivers' ``_refit`` with the sampler replaced: the same draws in the
    same order, and the last one carried as the model's parameters."""
    label = 1000.0 * np.arange(chains)[:, None] + np.arange(samples)[None]
    kwargs = {"num_chains": chains, "num_warmup": 1, "num_samples": samples,
              "num_leapfrog": 1, "max_depth": 1, "mixture_samples": mixture}

    def j_sampler(*args, **kw):
        return jnp.asarray(label), {}

    jd = jopt.ScaMLGPBO.__new__(jopt.ScaMLGPBO)
    jd.fit_method, jd.hmc_kwargs, jd.target_cfg = "hmc", kwargs, None
    jd.model = Model(params=None)
    with pytest.MonkeyPatch.context() as mp:
        from scamlgp_tpu.models import hmc as jhmc
        mp.setattr(jhmc, "sample_scamlgp_hyperparameters", j_sampler)
        jd._refit(jax.random.PRNGKey(0))

    td = ScaMLGPBO.__new__(ScaMLGPBO)
    td.fit_method, td.hmc_kwargs, td.target_cfg = "hmc", kwargs, None
    td.model, td._generator = Model(params=None), None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thmc, "sample_scamlgp_hyperparameters",
                   lambda *a, **k: (torch.as_tensor(label), {}))
        td._refit(None)
    np.testing.assert_array_equal(td._hyper_samples.numpy(),
                                  np.asarray(jd._hyper_samples))
    assert float(td.model.params) == float(jd.model.params)
    assert len(td._hyper_samples) == min(mixture, chains * samples)


def test_predict_equals_the_jax_mixture_predictive():
    """A port driver after two HMC refits; its model and draws handed to
    the JAX driver's ``predict``."""
    opt = ScaMLGPBO(conformance._space_1d(0), Objective("loss", False),
                    conformance.META_DATA_1D, seed=1, fit_method="hmc",
                    **SMALL)
    _drive(opt, steps=2)
    jd = jopt.ScaMLGPBO.__new__(jopt.ScaMLGPBO)
    jd.search_space = jconf._space_1d(0)
    jd.objective = JObjective("loss", False)
    jd.fit_method, jd.dtype = "hmc", jnp.float64
    jd.source_cfg = jgp.source_gp_config()
    jd.target_cfg = jgp.target_gp_config()
    jd.model = case.to_jax(opt.model)
    jd._hyper_samples = case.to_jax(opt._hyper_samples)
    configs = [{"x0": v} for v in (0.6, 1.1, 1.7, 2.4, 2.9)]
    jmean, jstd = jd.predict(configs)
    tmean, tstd = opt.predict(configs)
    np.testing.assert_allclose(tmean, np.asarray(jmean), rtol=1e-10)
    np.testing.assert_allclose(tstd, np.asarray(jstd), rtol=1e-10)


def test_mixture_acquisition_moment_matches_each_draw():
    """The driver's mixture acquisition applies UCB once to the draws'
    moment-matched predictive: equal to UCB of ``mixture_moments`` over the
    draws' own cached predictives, each computed alone."""
    opt = ScaMLGPBO(conformance._space_1d(0), Objective("loss", False),
                    conformance.META_DATA_1D, seed=2, fit_method="vi",
                    **SMALL)
    _drive(opt, steps=2)
    x = torch.linspace(0.05, 0.95, 9, dtype=torch.float64)[:, None]
    states = tm.scamlgp_acq_state(opt.model, opt.source_cfg, opt.target_cfg,
                                  params=opt._hyper_samples)
    af = opt._acquisition()
    value = topt._acq_value_mixture(opt.model, opt.source_cfg,
                                    opt.target_cfg, af, states,
                                    torch.tensor(0.0))(x)
    means, variances = [], []
    for k in range(4):
        p = tm.TargetParams(raw_weights=opt._hyper_samples.raw_weights[k],
                            gp=tgp.GPParams(*[leaf[k] for leaf in
                                              opt._hyper_samples.gp]))
        st = tm.scamlgp_acq_state(opt.model, opt.source_cfg, opt.target_cfg,
                                  params=p)
        mu, var = tm.scamlgp_posterior_diag_cached(
            opt.model, opt.source_cfg, opt.target_cfg, st, x)
        means.append(mu)
        variances.append(var)
    mean, var = thmc.mixture_moments(torch.stack(means),
                                     torch.stack(variances))
    np.testing.assert_allclose(value.numpy(),
                               af(mean, var.clamp_min(1e-30)).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("fit_method", ["hmc", "vi"])
def test_mixture_acquisition_matches_jax(fit_method):
    """The driver's mixture acquisition at fixed points equals the JAX
    driver's ``_acq_value_hmc`` (``bo/optimizer.py:73-90``) on the same
    model and draws, each draw's state built as the JAX ``_propose`` builds
    it (rtol 1e-10)."""
    from scamlgp_tpu.bo import acquisition as jacq
    from scamlgp_tpu.models import scamlgp as jm

    opt = ScaMLGPBO(conformance._space_1d(0), Objective("loss", False),
                    conformance.META_DATA_1D, seed=3, fit_method=fit_method,
                    **SMALL)
    _drive(opt, steps=2)
    x = torch.linspace(0.05, 0.95, 9, dtype=torch.float64)[:, None]
    best_f = min(opt.losses)
    states = tm.scamlgp_acq_state(opt.model, opt.source_cfg, opt.target_cfg,
                                  params=opt._hyper_samples)
    value = topt._acq_value_mixture(
        opt.model, opt.source_cfg, opt.target_cfg, opt._acquisition(),
        states, torch.tensor(best_f, dtype=torch.float64))(x)
    jmodel = case.to_jax(opt.model)
    jscfg, jtcfg = jgp.source_gp_config(), jgp.target_gp_config()
    jstates = jax.vmap(lambda p: jm.scamlgp_acq_state(
        jmodel, jscfg, jtcfg, params=p))(case.to_jax(opt._hyper_samples))
    jvalue = jax.vmap(lambda xx: jopt._acq_value_hmc(
        (jscfg, jtcfg, jacq.UpperConfidenceBound()),
        (jmodel, jstates, jnp.asarray(best_f)), xx))(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue),
                               rtol=1e-10)
