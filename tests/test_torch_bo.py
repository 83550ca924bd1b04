"""Port parity: acquisition functions and the acquisition ascent
(``bo/acquisition.py``, ``bo/optimize.py``) against the JAX package in
float64, on the same raw-sample array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.bo import acquisition as ja
from scamlgp_tpu.bo import optimize as jo
from scamlgp_tpu_torch.bo import acquisition as ta
from scamlgp_tpu_torch.bo import optimize as to

F64 = torch.float64
ACQS = ["UpperConfidenceBound", "ExpectedImprovement",
        "ProbabilityOfImprovement", "LogExpectedImprovement"]


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("name", ACQS)
def test_acquisition_values(name, maximize):
    rng = np.random.default_rng(0)
    mean = rng.normal(size=50) * 2
    var = rng.uniform(1e-4, 3.0, size=50)
    jv = getattr(ja, name)(maximize=maximize)(jnp.asarray(mean),
                                              jnp.asarray(var), 0.3)
    tv = getattr(ta, name)(maximize=maximize)(
        torch.as_tensor(mean), torch.as_tensor(var), 0.3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10,
                               atol=1e-12)


def test_sobol_unit_matches():
    np.testing.assert_array_equal(to.sobol_unit(7, 64, 3).numpy(),
                                  np.asarray(jo.sobol_unit(7, 64, 3,
                                                           jnp.float64)))


def _bowl(jnp_or_torch, c):
    def f(x):
        r = ((x - c) ** 2).sum(-1)
        return -r + 0.1 * jnp_or_torch.cos(8.0 * x[..., 0])
    return f


def _jax_value(static_args, args, x):
    return _bowl(jnp, args)(x)


def test_optimize_acqf_matches_on_the_same_raw():
    c = np.array([0.3, 0.7])
    raw = np.array(jo.sobol_unit(3, 64, 2, jnp.float64))
    jres = jo._optimize(_jax_value, None, jnp.asarray(c), jnp.asarray(raw),
                        num_restarts=4, num_steps=20, lr=0.05)
    tres = to.optimize_acqf(_bowl(torch, torch.as_tensor(c)), 2, seed=0,
                            num_restarts=4, num_steps=20,
                            raw=torch.as_tensor(raw))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10)
    np.testing.assert_allclose(tres.value.item(), float(jres.value),
                               rtol=1e-10)


def test_optimize_acqf_sobol_path_stays_in_the_cube():
    res = to.optimize_acqf(_bowl(torch, torch.tensor([0.2, 0.9],
                                                     dtype=F64)),
                           2, seed=5, raw_samples=128, num_restarts=3,
                           num_steps=15)
    assert ((res.x >= 0) & (res.x <= 1)).all()
    assert res.value.dtype == F64
