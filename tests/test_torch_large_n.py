"""Port parity: BASELINE config 5's large-N checks
(``validate_large_n``, ``validate_large_n_fit``) against the JAX package,
in float64 on the CPU, at small N.

- ``validate_large_n``'s per-N computation at N = 64 and 128 (d = 3, 8
  queries, the data of one ``default_rng(0)`` in the script's order): the
  float64 posterior mean and variance against the JAX ``gp.condition`` /
  ``gp.predict(full_cov=False)`` on the same arrays and the same
  mid-range parameters, rtol 1e-9; each row's ``pass`` flag and
  condition number against ``scripts/validate_large_n.py`` run as
  ``__main__`` on the same sizes (the conftest's CPU platform and x64).
- ``validate_large_n_fit.fit_rows`` at N = 64, 3 restarts, 15 steps: its
  ``oracle_f64`` leg against the JAX ``fit_map_restarts`` of
  ``gp.map_objective`` from the same restart stack, raw parameters and
  objective at rtol 1e-8; the other two legs finite, each against the
  oracle.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu_torch import validate_large_n as vl
from scamlgp_tpu_torch import validate_large_n_fit as vlf
from scamlgp_tpu_torch.models import gp as tgp
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES, D, QUERIES = (64, 128), 3, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {N: vl.draw(rng, N, D, QUERIES) for N in SIZES}


def _jax_posterior(X, y, Xq):
    cfg = jgp.source_gp_config()
    p = jgp.GPParams(
        raw_lengthscale=cfg.lengthscale_constraint.inverse(
            jnp.full((D,), 0.6)),
        raw_outputscale=cfg.outputscale_constraint.inverse(jnp.asarray(1.0)),
        raw_noise=cfg.noise_constraint.inverse(jnp.asarray(1e-3)))
    ps = jgp.condition(cfg, p, jnp.asarray(X), jnp.asarray(y))
    mean, var = jgp.predict(cfg, ps, jnp.asarray(Xq), full_cov=False)
    return np.asarray(mean), np.asarray(var), float(
        jgp.mll(cfg, p, jnp.asarray(X), jnp.asarray(y)))


@pytest.mark.parametrize("N", SIZES)
def test_f64_posterior_matches_jax(data, N):
    X, y, Xq = data[N]
    mean, var, mll = vl.predictions(X, y, Xq, torch.float64, "cpu")
    jmean, jvar, jmll = _jax_posterior(X, y, Xq)
    np.testing.assert_allclose(mean, jmean, rtol=1e-9, atol=0)
    np.testing.assert_allclose(var, jvar, rtol=1e-9, atol=0)
    assert mll == pytest.approx(jmll, rel=1e-9)


def test_rows_match_the_jax_script(tmp_path, monkeypatch):
    """The port's rows and the JAX script's on the same sizes: the same
    pass flags and condition numbers (rtol 1e-6, extreme eigenvalues
    against the SVD, beside the script's rounding to 0.1)."""
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", [
        "scripts/validate_large_n.py", "--sizes", *map(str, SIZES),
        "--queries", str(QUERIES), "--d", str(D), "--out", str(out)])
    runpy.run_path(os.path.join(ROOT, "scripts/validate_large_n.py"),
                   run_name="__main__")
    ref = json.loads(out.read_text())
    port = vl.run(SIZES, QUERIES, D, device="cpu")
    assert port["all_pass"] == ref["all_pass"]
    for row, jrow in zip(port["rows"], ref["rows"]):
        assert row["N"] == jrow["N"]
        assert row["pass"] == jrow["pass"]
        # the script rounds its condition number to 0.1
        assert row["cond_est"] == pytest.approx(jrow["cond_est"], rel=1e-6,
                                                abs=0.05)
        assert set(row) == set(jrow)


@pytest.fixture(scope="module")
def fit_case():
    X, y, stack = vlf.draw(64, D, 3, 1e-3)
    row = vlf.fit_rows(X, y, stack, steps=15, device="cpu")
    return X, y, stack, row


def test_fit_oracle_leg_matches_jax(fit_case):
    X, y, stack, row = fit_case
    cfg = jgp.source_gp_config()
    jstack = jgp.GPParams(*[jnp.asarray(leaf) for leaf in stack])
    res = jax.jit(lambda s: jfit.fit_map_restarts(
        lambda p: jgp.map_objective(cfg, p, jnp.asarray(X), jnp.asarray(y)),
        s, num_steps=15))(jstack)
    oracle = row["oracle_f64"]
    for name in jgp.GPParams._fields:
        np.testing.assert_allclose(
            oracle["raw"][name], np.atleast_1d(np.asarray(getattr(
                res.params, name))), rtol=1e-8, atol=0)
    assert oracle["fit_objective"] == pytest.approx(float(res.objective),
                                                    rel=1e-8)
    assert oracle["objective_f64"] == pytest.approx(float(res.objective),
                                                    rel=1e-8)


def test_fit_row_legs(fit_case):
    """The float32 legs are finite and held to the oracle by their float64
    objectives; the stack is the constraints' initial values, then the
    prior draws."""
    X, y, stack, row = fit_case
    assert row["restarts"] == 4 and row["N"] == 64 and row["d"] == D
    assert stack.raw_lengthscale.shape == (4, D)
    init = tgp.init_params(tgp.source_gp_config(), D, torch.float64)
    np.testing.assert_array_equal(stack.raw_noise[0], init.raw_noise.numpy())
    for leg in ("f32_fit", "f32_chol64"):
        assert np.isfinite(row[leg]["objective_f64"])
        assert row[leg]["wall_s"] > 0
    for key in ("f32_vs_oracle", "chol64_vs_oracle"):
        assert abs(row[key]["objective_gap"]) < 1e-2 * abs(
            row["oracle_f64"]["objective_f64"])
    assert row["f32_fit_launches"] == {}
