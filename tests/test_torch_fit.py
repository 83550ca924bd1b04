"""Port parity: the batched lock-step L-BFGS (``models/fit.py``) against the
JAX package's ``_lbfgs_minimize`` (optax L-BFGS, memory 10, zoom line
search of at most 20 steps) from the same init stack, float64.  The first
five iterates agree to 1e-8; the final objective to 1e-6 relative."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu_torch.convert import gp_params, to_numpy_dict
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(4)
    n, d, R = 12, 2, 4
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    mask = np.ones(n)
    mask[10:] = 0.0
    y = y * mask
    cfg = jgp.source_gp_config()
    warm = jgp.init_params(cfg, d, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(7), R - 1)
    sampled = jax.vmap(lambda k: jgp.sample_params(cfg, k, d,
                                                   jnp.float64))(keys)
    stack = jfit.stack_restarts(warm, sampled)
    return dict(X=X, y=y, mask=mask, stack=stack, R=R)


def _jax_objective(problem):
    cfg = jgp.source_gp_config()
    return lambda p: jgp.map_objective(cfg, p, problem["X"], problem["y"],
                                       problem["mask"])


def _torch_objective(problem, method="chol"):
    cfg = tgp.source_gp_config()
    X, y, mask = (torch.as_tensor(problem[k], dtype=F64)
                  for k in ("X", "y", "mask"))
    return lambda p: tgp.map_objective(cfg, p, X, y, mask, method=method)


@pytest.fixture(scope="module")
def jax_runs(problem):
    """The reference after 1..5 steps, and its 40-step restart fit, in one
    compile."""
    obj = _jax_objective(problem)

    def runs(stack):
        first = [jax.vmap(partial(jfit._lbfgs_minimize, obj, num_steps=k))(
            stack) for k in range(1, 6)]
        return first, jfit.fit_map_restarts(obj, stack, num_steps=40)

    return jax.jit(runs)(problem["stack"])


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5])
def test_first_iterates_match_optax(problem, jax_runs, steps):
    jp, jv = jax_runs[0][steps - 1]
    tstack = gp_params(to_numpy_dict(problem["stack"]), device="cpu")
    obj = _torch_objective(problem)
    x0 = tfit.flatten(tstack, 1)
    tp, tv = tfit.lbfgs_minimize(
        lambda x: obj(tfit.unflatten(x, tstack, 1)), x0, steps)
    np.testing.assert_allclose(tp.numpy(), tfit.flatten(
        gp_params(to_numpy_dict(jp), device="cpu"), 1).numpy(),
        rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8)


@pytest.mark.parametrize("method", ["chol", "sweep"])
def test_fit_map_restarts_final_objective(problem, jax_runs, method):
    steps = 40
    jres = jax_runs[1]
    tstack = gp_params(to_numpy_dict(problem["stack"]), device="cpu")
    tres = tfit.fit_map_restarts(_torch_objective(problem, method), tstack,
                                 num_steps=steps)
    np.testing.assert_allclose(tres.all_objectives.numpy(),
                               np.asarray(jres.all_objectives), rtol=1e-6)
    np.testing.assert_allclose(tres.objective.item(), float(jres.objective),
                               rtol=1e-6)
    assert tres.params.raw_lengthscale.shape == (2,)


def test_fit_map_restarts_batch_axes_and_nonfinite(problem):
    """A leading batch axis in front of the restarts; a restart that starts
    where the objective is NaN loses the argmin."""
    tstack = gp_params(to_numpy_dict(problem["stack"]), device="cpu")
    two = tfit.tree_map(lambda leaf: torch.stack([leaf, leaf]), tstack)
    two.raw_noise[1, 0] = float("nan")
    res = tfit.fit_map_restarts(_torch_objective(problem), two, num_steps=15,
                                batch_ndim=1)
    assert res.all_objectives.shape == (2, problem["R"])
    assert torch.isinf(res.all_objectives[1, 0])
    assert torch.isfinite(res.objective).all()
    assert res.params.raw_lengthscale.shape == (2, 2)


def test_stack_restarts_and_flatten_round_trip(problem):
    tstack = gp_params(to_numpy_dict(problem["stack"]), device="cpu")
    warm = tfit.tree_map(lambda leaf: leaf[0], tstack)
    stacked = tfit.stack_restarts(warm, tstack)
    assert stacked.raw_lengthscale.shape == (problem["R"] + 1, 2)
    flat = tfit.flatten(stacked, 1)
    back = tfit.unflatten(flat, stacked, 1)
    for a, b in zip(back, stacked):
        assert torch.equal(a, b)
