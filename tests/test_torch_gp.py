"""Port parity: the single-task GP (``models/gp.py``) against the JAX
package in float64.  Both port methods ("chol" and "sweep") are held
against the JAX ``method="chol"`` values and gradients — never against the
JAX sweep route's gradients, which carry the reference's cotangent-shape
fault (ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu_torch.convert import gp_params, to_numpy_dict
from scamlgp_tpu_torch.models import gp as tgp

F64 = torch.float64


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    n, d = 10, 2
    X = rng.uniform(size=(n, d))
    y = rng.normal(size=n)
    mask = np.ones(n)
    mask[7:] = 0.0
    y = y * mask
    A = rng.normal(size=(n, n))
    prior_cov = 0.1 * A @ A.T / n
    prior_mean = 0.3 * rng.normal(size=n)
    p = jgp.GPParams(raw_lengthscale=jnp.asarray([-0.4, 0.3]),
                     raw_outputscale=jnp.asarray(-1.2),
                     raw_noise=jnp.asarray(-2.0))
    return dict(X=X, y=y, mask=mask, prior_cov=prior_cov,
                prior_mean=prior_mean, p=p)


CASES = [(cfg, method, extras)
         for cfg in ("source", "target")
         for method in ("chol", "sweep")
         for extras in (False, True)]


@pytest.mark.parametrize("cfg_name,method,extras", CASES)
def test_map_objective_value_and_grad(problem, cfg_name, method, extras):
    jcfg = getattr(jgp, f"{cfg_name}_gp_config")()
    tcfg = getattr(tgp, f"{cfg_name}_gp_config")()
    kw_np = (dict(prior_mean=problem["prior_mean"],
                  prior_cov=problem["prior_cov"]) if extras else {})
    X, y, mask = problem["X"], problem["y"], problem["mask"]

    def jfn(p):
        return jgp.map_objective(jcfg, p, X, y, mask,
                                 **{k: jnp.asarray(v) for k, v in kw_np.items()},
                                 method="chol")

    jv, jg = jax.value_and_grad(jfn)(problem["p"])
    tp = gp_params(to_numpy_dict(problem["p"]), device="cpu")
    tp = tgp.GPParams(*[leaf.requires_grad_(True) for leaf in tp])
    tv = tgp.map_objective(tcfg, tp, T(X), T(y), T(mask),
                           **{k: T(v) for k, v in kw_np.items()},
                           method=method)
    tg = torch.autograd.grad(tv, list(tp))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-10)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("method", ["chol", "sweep", "chol64"])
def test_batched_mll_matches_per_instance(problem, method):
    """Leading restart axes on the parameters broadcast against the data."""
    rng = np.random.default_rng(2)
    raw = dict(raw_lengthscale=rng.normal(size=(3, 2)),
               raw_outputscale=rng.normal(size=3),
               raw_noise=rng.normal(size=3) - 2)
    cfg_j, cfg_t = jgp.source_gp_config(), tgp.source_gp_config()
    X, y, mask = problem["X"], problem["y"], problem["mask"]
    jv = jax.vmap(lambda p: jgp.mll(cfg_j, p, X, y, mask))(
        jgp.GPParams(**{k: jnp.asarray(v) for k, v in raw.items()}))
    tv = tgp.mll(cfg_t, gp_params(raw, device="cpu"), T(X), T(y), T(mask),
                 method=method)
    assert tv.shape == (3,)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)


def test_unknown_mll_method_raises(problem):
    with pytest.raises(ValueError):
        tgp.mll(tgp.source_gp_config(),
                gp_params(to_numpy_dict(problem["p"]), device="cpu"),
                T(problem["X"]), T(problem["y"]), method="cholesky")


@pytest.mark.parametrize("full_cov", [True, False])
def test_condition_predict(problem, full_cov):
    rng = np.random.default_rng(9)
    Xq = rng.uniform(size=(5, 2))
    jcfg, tcfg = jgp.target_gp_config(), tgp.target_gp_config()
    X, y, mask = problem["X"], problem["y"], problem["mask"]
    jps = jgp.condition(jcfg, problem["p"], X, y, mask,
                        prior_cov=problem["prior_cov"],
                        prior_mean=problem["prior_mean"])
    jm, jc = jgp.predict(jcfg, jps, Xq, full_cov=full_cov)
    tp = gp_params(to_numpy_dict(problem["p"]), device="cpu")
    tps = tgp.condition(tcfg, tp, T(X), T(y), T(mask),
                        prior_cov=T(problem["prior_cov"]),
                        prior_mean=T(problem["prior_mean"]))
    tm, tc = tgp.predict(tcfg, tps, T(Xq), full_cov=full_cov)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("cfg_name", ["source", "target"])
def test_init_params_constrain_log_prior(cfg_name):
    jcfg = getattr(jgp, f"{cfg_name}_gp_config")()
    tcfg = getattr(tgp, f"{cfg_name}_gp_config")()
    jp0 = jgp.init_params(jcfg, 3, jnp.float64)
    tp0 = tgp.init_params(tcfg, 3, F64, "cpu", batch_shape=(2,))
    for a, b in zip(tp0, jp0):
        np.testing.assert_allclose(a[1].numpy(), np.asarray(b), rtol=1e-12)
    jc_ = jgp.constrain(jcfg, jp0)
    tc_ = tgp.constrain(tcfg, tp0)
    np.testing.assert_allclose(tgp.log_prior(tcfg, tc_).numpy(),
                               [float(jgp.log_prior(jcfg, jc_))] * 2,
                               rtol=1e-12)


def test_sample_params_inside_constraints():
    cfg = tgp.source_gp_config()
    g = torch.Generator().manual_seed(3)
    p = tgp.sample_params(cfg, g, 2, F64, batch_shape=(500,))
    c = tgp.constrain(cfg, p)
    for v, con in ((c.lengthscale, cfg.lengthscale_constraint),
                   (c.outputscale, cfg.outputscale_constraint),
                   (c.noise, cfg.noise_constraint)):
        assert torch.isfinite(v).all()
        assert (v > con.lower).all() and (v < con.upper).all()
