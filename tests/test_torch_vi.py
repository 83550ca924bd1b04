"""Port parity of ``models/vi.py``: ADVI steps, ``sample_q`` and
``fit_scamlgp_vi``, on the CPU in float64.

Both packages get the same random numbers: ``torch_posterior_case``
rebuilds the JAX key's draws (``vi.py:92,128,136,159``) as the tensors the
port takes.  The log-density of the ADVI runs is a 2-D Gaussian that is
NaN for x0 > 1.3: started at x0 = 1.3, about half the Monte-Carlo draws of
a step are NaN (the per-draw masked estimator); started at x0 = 3, every
draw is (each step is skipped, and q stays where it started).  One step
and 20 steps are held to the JAX ones at rtol 1e-8, as is
``fit_scamlgp_vi`` on the ScaML-GP target of ``tests/test_hmc.py:72-81``
(20 steps x 4 draws, 6 mixture draws, JAX ``chol`` MLL).

Port-only: ADVI recovers a known Gaussian's moments (the calibration of
``tests/test_vi.py:12-35``, with a torch generator), and a batch of two
fits equals each fit alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_posterior_case as case
from scamlgp_tpu.models import hmc as jhmc
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.models import vi as jvi
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.models import vi as tvi
from tests.torch_threads import one_thread  # noqa: F401


RTOL = 1e-8
MU = np.array([1.0, -2.0])
SIGMA = np.array([0.5, 2.0])
EDGE = 1.3      # the log-density is NaN beyond x0 = EDGE
NUM_MC = 4


def jax_log_prob(x):
    lp = -0.5 * jnp.sum(((x - MU) / SIGMA) ** 2)
    return jnp.where(x[0] > EDGE, jnp.nan, lp)


def torch_log_prob(x):
    mu, sigma = torch.as_tensor(MU), torch.as_tensor(SIGMA)
    lp = -0.5 * torch.sum(((x - mu) / sigma) ** 2, dim=-1)
    return torch.where(x[..., 0] > EDGE, torch.nan, lp)


def both_advi(x0, steps, key):
    """Both packages' ADVI from (x0, 0.5) on the same draws: (JAX q, JAX
    trace, port q, port trace, port unflatten)."""
    init = jnp.asarray([x0, 0.5])

    @jax.jit
    def run(init, key):
        q, _, info = jvi.advi(jax_log_prob, init, key, num_steps=steps,
                              num_mc=NUM_MC, lr=0.05)
        return q, info["neg_elbo_trace"]

    jq, jtrace = run(init, key)
    tq, unflatten, info = tvi.advi(torch_log_prob, case.tensor(init),
                                   case.advi_eps(key, steps, NUM_MC, 2),
                                   lr=0.05)
    return jq, jtrace, tq, info["neg_elbo_trace"], unflatten


def assert_q(jq, tq):
    for j, t in zip(jq, tq):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=1e-12)


@pytest.mark.parametrize("steps", [1, 20])
def test_advi_with_masked_draws_matches_jax(steps):
    """About half the draws of each step are NaN: the estimator averages
    over the finite ones."""
    jq, jtrace, tq, ttrace, _ = both_advi(EDGE, steps, jax.random.PRNGKey(1))
    eps = case.advi_eps(jax.random.PRNGKey(1), steps, NUM_MC, 2)
    first = EDGE + np.exp(-2.0) * eps[0, :, 0].numpy()
    assert 0 < np.sum(first > EDGE) < NUM_MC
    assert_q(jq, tq)
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace), rtol=RTOL)
    assert np.all(np.isfinite(ttrace.numpy()))


def test_advi_skips_a_step_with_no_finite_draw():
    jq, jtrace, tq, ttrace, _ = both_advi(3.0, 20, jax.random.PRNGKey(2))
    assert np.all(np.isinf(ttrace.numpy())) and np.all(
        np.isinf(np.asarray(jtrace)))
    assert_q(jq, tq)
    np.testing.assert_array_equal(tq.mu.numpy(), [3.0, 0.5])
    np.testing.assert_array_equal(tq.log_sigma.numpy(), [-2.0, -2.0])


def test_sample_q_matches_jax():
    jq, _, tq, _, unflatten = both_advi(EDGE, 20, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(4)
    _, junflatten = jhmc._flatten(jnp.zeros(2))
    jdraws = jvi.sample_q(jq, junflatten, key, 7)
    tdraws = tvi.sample_q(tq, unflatten, case.q_normals(key, 7, 2))
    assert tdraws.shape == (7, 2)
    np.testing.assert_allclose(tdraws.numpy(), np.asarray(jdraws),
                               rtol=RTOL)


def test_fit_scamlgp_vi_matches_jax():
    jmodel, tmodel = case.target_models()
    key = jax.random.PRNGKey(5)
    warm = jm.init_target_params(case.JCFG, 2, 1, case.F64)
    js, jinfo = jax.jit(lambda k: jvi.fit_scamlgp_vi(
        jmodel, case.JCFG, k, num_steps=20, num_mc=NUM_MC, num_draws=6,
        init_params=warm))(key)
    ts, tinfo = tvi.fit_scamlgp_vi(
        tmodel, case.TCFG, num_steps=20, num_mc=NUM_MC, num_draws=6,
        init_params=tm.init_target_params(case.TCFG, 2, 1, torch.float64),
        draws=case.vi_draws(key, 20, NUM_MC, 6, 5))
    assert ts.raw_weights.shape == (6, 2)
    for j, t in zip(jax.tree_util.tree_leaves(js), tfit.tree_leaves(ts)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=1e-12)
    jq = convert.mean_field_q(convert.to_numpy_dict(jinfo["q"]),
                              device="cpu")
    assert_q(jq, tinfo["q"])
    np.testing.assert_allclose(tinfo["neg_elbo_trace"].numpy(),
                               np.asarray(jinfo["neg_elbo_trace"]),
                               rtol=RTOL)


def test_advi_recovers_gaussian_moments():
    """For a Gaussian target the mean-field family is exact."""
    mu = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    sigma = torch.tensor([0.5, 2.0, 1.0], dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    draws = tvi.vi_draws(g, (), 800, 16, 2000, 3)
    q, unflatten, info = tvi.advi(
        lambda x: -0.5 * torch.sum(((x - mu) / sigma) ** 2, dim=-1),
        torch.zeros(3, dtype=torch.float64), draws.eps, lr=0.05)
    np.testing.assert_allclose(q.mu.numpy(), mu.numpy(), atol=0.1)
    np.testing.assert_allclose(torch.exp(q.log_sigma).numpy(),
                               sigma.numpy(), rtol=0.2)
    trace = info["neg_elbo_trace"].numpy()
    assert np.isfinite(trace).all()
    assert trace[-50:].mean() < trace[:50].mean()
    xs = tvi.sample_q(q, unflatten, draws.sample).numpy()
    np.testing.assert_allclose(xs.mean(0), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(xs.std(0), sigma.numpy(), rtol=0.25)


def test_batched_advi_equals_each_fit_alone():
    """Two fits as one batch (their Monte-Carlo draws one log-density call a
    step, each with its own Adam state and skip guard) equal each fit run
    alone; the second starts where every draw is NaN."""
    g = torch.Generator().manual_seed(3)
    eps = torch.randn((2, 15, NUM_MC, 2), generator=g, dtype=torch.float64)
    init = torch.tensor([[0.0, 0.5], [3.0, 0.5]], dtype=torch.float64)
    qb, _, ib = tvi.advi(torch_log_prob, init, eps, batch_ndim=1)
    for b in range(2):
        q1, _, i1 = tvi.advi(torch_log_prob, init[b], eps[b])
        for t, t1 in zip(qb, q1):
            np.testing.assert_allclose(t[b].numpy(), t1.numpy(), rtol=1e-14)
        np.testing.assert_array_equal(ib["neg_elbo_trace"][b].numpy(),
                                      i1["neg_elbo_trace"].numpy())
