"""Port parity of ``models/hmc.py``: the leapfrog, HMC and NUTS chains and
the posterior mixture predictive, on the CPU in float64.

Both packages get the same random numbers: the JAX sampler draws them from
its key, and ``torch_posterior_case`` rebuilds those draws, in the order in
which the JAX code splits the key, as the tensors the port's samplers
take.  Two targets: a 2-D Gaussian, and the ScaML-GP target of
``tests/test_hmc.py:72-81`` (2 meta-tasks x 16 points, d=1, 5 target
points, a fixed data seed), both on the JAX ``chol`` MLL.  Short chains
(6 warmup + 4 samples, 2 chains) are held to the JAX ones at rtol 1e-8:
positions, final step sizes and accept probabilities.  No accept decision
of these chains lies within 1e-6 of its uniform, so none flips on
roundoff.

Port-only: the samplers reproduce a known Gaussian's moments (the
calibration of ``tests/test_hmc.py:11-50``, with a torch generator), and
the single-task GP sampler runs finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_posterior_case as case
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import hmc as jhmc
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import hmc as thmc
from scamlgp_tpu_torch.models import scamlgp as tm
from tests.torch_threads import one_thread  # noqa: F401


RTOL = 1e-8
CHAINS, WARMUP, SAMPLES, LEAPFROG, DEPTH = 2, 6, 4, 4, 3
DIM = 2 + 1 + 2   # the ScaML-GP target's M weights, d lengthscales, 2
MU = np.array([1.0, -2.0])
SIGMA = np.array([0.5, 2.0])


def jax_gauss(x):
    return -0.5 * jnp.sum(((x - MU) / SIGMA) ** 2)


def torch_gauss(x):
    mu, sigma = torch.as_tensor(MU), torch.as_tensor(SIGMA)
    return -0.5 * torch.sum(((x - mu) / sigma) ** 2, dim=-1)


@pytest.fixture(scope="module")
def target():
    return case.target_models()


def gauss_problem(key):
    """Gaussian chains' run keys and starts, the starts drawn from the
    chains' init keys."""
    k_init, k_run = case.chain_keys(key, CHAINS)
    jinit = jax.vmap(lambda k: jax.random.normal(k, (2,), case.F64))(k_init)
    return k_run, jinit, case.tensor(jinit)


def run_both(name, sampler, target, key):
    """Both packages' chains of ``sampler`` on target ``name``, on the same
    draws: (JAX samples, JAX info, port samples, port info).  On the
    ScaML-GP target through each package's
    ``sample_scamlgp_hyperparameters``, chains started at prior draws."""
    kw = ({"max_depth": DEPTH} if sampler == "nuts"
          else {"num_leapfrog": LEAPFROG})
    T = WARMUP + SAMPLES
    if name == "gauss":
        run, jinit, tinit = gauss_problem(key)
        fn = jhmc.nuts if sampler == "nuts" else jhmc.hmc
        js, ji = jax.jit(jax.vmap(lambda init, k: fn(
            jax_gauss, init, k, num_warmup=WARMUP, num_samples=SAMPLES,
            **kw)))(jinit, run)
        draws = (case.nuts_draws(run, T, 2, DEPTH) if sampler == "nuts"
                 else case.hmc_draws(run, T, 2))
        tfn = thmc.nuts if sampler == "nuts" else thmc.hmc
        ts, ti = tfn(torch_gauss, tinit, draws, num_warmup=WARMUP,
                     num_samples=SAMPLES, batch_ndim=1, **kw)
        return js, ji, ts, ti
    jmodel, tmodel = target
    js, ji = jax.jit(lambda k: jhmc.sample_scamlgp_hyperparameters(
        jmodel, case.JCFG, k, num_chains=CHAINS, num_warmup=WARMUP,
        num_samples=SAMPLES, sampler=sampler, **kw))(key)
    k_init, run = case.chain_keys(key, CHAINS)
    _, tinit = case.target_inits(k_init, case.JCFG, 2, 1)
    draws = (case.nuts_draws(run, T, DIM, DEPTH) if sampler == "nuts"
             else case.hmc_draws(run, T, DIM))
    ts, ti = thmc.sample_scamlgp_hyperparameters(
        tmodel, case.TCFG, num_chains=CHAINS, num_warmup=WARMUP,
        num_samples=SAMPLES, sampler=sampler, init=tinit, draws=draws, **kw)
    return js, ji, ts, ti


def assert_samples(jsamples, jinfo, tsamples, tinfo):
    assert tinfo["accept_prob"].shape == (CHAINS, SAMPLES)
    for j, t in zip(jax.tree_util.tree_leaves(jsamples),
                    tfit.tree_leaves(tsamples)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=1e-12)
    for k in ("accept_prob", "step_size"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", ["gauss", "scamlgp"])
def test_leapfrog_matches_jax(name, target):
    """Five leapfrog steps from one point, a diagonal inverse mass."""
    if name == "gauss":
        jlp, tlp, dim = jax_gauss, torch_gauss, 2
        _, jinit, _ = gauss_problem(jax.random.PRNGKey(5))
        q0 = jinit[0]
    else:
        (jmodel, tmodel), dim = target, DIM
        q0 = jm.init_target_params(case.JCFG, 2, 1, case.F64)
        jlp = lambda p: -jm.scamlgp_map_objective(  # noqa: E731
            jmodel, case.JCFG, p)
        tlp = lambda p: -tm.scamlgp_map_objective(  # noqa: E731
            tmodel, case.TCFG, p)
    flat, unflatten = jhmc._flatten(q0)
    p = jax.random.normal(jax.random.PRNGKey(6), (dim,), case.F64)
    eps, inv_mass = 0.05, jnp.linspace(0.5, 1.5, dim)
    logp_grad = jax.value_and_grad(lambda q: jlp(unflatten(q)))

    @jax.jit
    def run(flat, p):
        _, g0 = logp_grad(flat)
        return g0, jhmc._leapfrog(logp_grad, flat, p, g0, eps, inv_mass, 5)

    g0, (jq, jp, jg, jl) = run(flat, p)
    if name == "gauss":
        like = torch.zeros((1, 2), dtype=torch.float64)
    else:
        like = tm.init_target_params(case.TCFG, 2, 1, torch.float64,
                                     batch_shape=(1,))
    _, _, tflat = thmc._flat_log_prob(tlp, like, 1)
    tq, tp, tg, tl = thmc.leapfrog(
        lambda q: thmc.log_prob_and_grad(tflat, q),
        case.tensor(flat)[None], case.tensor(p)[None],
        case.tensor(g0)[None], torch.full((1,), eps, dtype=torch.float64),
        case.tensor(inv_mass)[None], 5)
    for t, j in ((tq, jq), (tp, jp), (tg, jg)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=RTOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)


@pytest.fixture(scope="module")
def hmc_runs(target):
    return {name: run_both(name, "hmc", target, jax.random.PRNGKey(2))
            for name in ("gauss", "scamlgp")}


@pytest.mark.parametrize("name", ["gauss", "scamlgp"])
def test_hmc_matches_jax(name, hmc_runs):
    assert_samples(*hmc_runs[name])


@pytest.mark.parametrize("name", ["gauss", "scamlgp"])
def test_nuts_matches_jax(name, target):
    assert_samples(*run_both(name, "nuts", target, jax.random.PRNGKey(3)))


def test_posterior_mixture_diag_matches_jax(target, hmc_runs):
    jmodel, tmodel = target
    js, _, ts, _ = hmc_runs["scamlgp"]
    Xq = np.random.default_rng(0).uniform(size=(4, 1))
    jmean, jvar = jax.jit(lambda s, x: jhmc.posterior_mixture_diag(
        jmodel, jgp.source_gp_config(), case.JCFG, s, x, max_samples=6))(
        js, jnp.asarray(Xq))
    tmean, tvar = thmc.posterior_mixture_diag(
        tmodel, tgp.source_gp_config(), case.TCFG, ts, case.tensor(Xq),
        max_samples=6)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=RTOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=RTOL)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_samplers_reproduce_gaussian_moments(sampler):
    """Samples from N(mu, diag(sigma^2)) in 3-D reproduce its mean and std
    (4 chains, 300 warmup, 500 samples and the tolerances of
    ``tests/test_hmc.py``).  NUTS, in both packages, puts the std of the
    widest dimension (sigma 2) near 2.4: its U-turn check between the
    trajectory's ends only, not on every sub-subtree, over-disperses it."""
    mu, sigma = torch.tensor([1.0, -2.0, 0.5]), torch.tensor([0.5, 2.0, 1.0])
    g = torch.Generator().manual_seed(0)
    init = torch.randn((4, 3), generator=g, dtype=torch.float64)
    T = 300 + 500
    if sampler == "hmc":
        draws = thmc.hmc_draws(g, (4,), T, 3)
        samples, info = thmc.hmc(
            lambda x: -0.5 * torch.sum(((x - mu) / sigma) ** 2, dim=-1),
            init, draws, num_warmup=300, num_samples=500, num_leapfrog=8,
            batch_ndim=1)
    else:
        draws = thmc.nuts_draws(g, (4,), T, 3, 6)
        samples, info = thmc.nuts(
            lambda x: -0.5 * torch.sum(((x - mu) / sigma) ** 2, dim=-1),
            init, draws, num_warmup=300, num_samples=500, max_depth=6,
            batch_ndim=1)
    xs = samples.reshape(-1, 3).numpy()
    acc = float(info["accept_prob"].mean())
    assert 0.5 < acc <= 1.0, f"acceptance {acc}"
    np.testing.assert_allclose(xs.mean(0), mu.numpy(), atol=0.3)
    np.testing.assert_allclose(xs.std(0), sigma.numpy(), rtol=0.35)


def test_gp_hyperparameter_sampling_finite():
    """The single-task GP sampler (``tests/test_hmc.py:54-69``, 60 warmup
    and 30 samples where it runs 100 and 50): finite lengthscales inside
    their constraint, a fair acceptance."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(size=(24, 2)))
    y = torch.sin(5 * X[:, 0]) + 0.1 * torch.as_tensor(rng.normal(size=24))
    y = (y - y.mean()) / y.std()
    cfg = tgp.source_gp_config()
    samples, info = thmc.sample_gp_hyperparameters(
        cfg, X, y, torch.ones(24), torch.Generator().manual_seed(0),
        num_chains=2, num_warmup=60, num_samples=30, num_leapfrog=8)
    ls = tgp.constrain(cfg, samples).lengthscale.numpy()
    assert ls.shape == (2, 30, 2)
    assert np.all(np.isfinite(ls)) and np.all((ls >= 1e-4) & (ls <= 1e2))
    assert float(info["accept_prob"].mean()) > 0.3
