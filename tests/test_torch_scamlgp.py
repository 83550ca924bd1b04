"""Port parity: the ScaML-GP model (``models/scamlgp.py``) against the JAX
package in float64.  The meta-fit starts from the JAX draws (reproduced by
``jax.random.split`` plus ``gp.sample_params``) passed in as ``init_stack``;
fitted parameters and the posterior agree at rtol 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
STEPS, RESTARTS = 15, 2


def close(a, b, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def meta():
    rng = np.random.default_rng(8)
    sizes = [10, 7, 9]
    xs = [rng.uniform(size=(n, 2)) for n in sizes]
    ys = [np.sin(4 * x[:, 0]) * (i + 1) + x[:, 1] + 0.05 * rng.normal(
        size=len(x)) for i, x in enumerate(xs)]
    return xs, ys


@pytest.fixture(scope="module")
def fitted(meta):
    xs, ys = meta
    cfg = jgp.source_gp_config()
    jdata = jm.pack_task_data(xs, ys, dtype=jnp.float64)
    key = jax.random.PRNGKey(3)
    jstack = jm.meta_fit_task_stack(jdata, cfg, key, num_restarts=RESTARTS,
                                    num_steps=STEPS)
    # the JAX draws, made as meta_fit_task_stack makes them
    warm = jgp.init_params(cfg, 2, jnp.float64)

    def task_init(task_key):
        keys = jax.random.split(task_key, RESTARTS)
        sampled = jax.vmap(lambda k: jgp.sample_params(cfg, k, 2,
                                                       jnp.float64))(keys)
        return jfit.stack_restarts(warm, sampled)

    init = jax.vmap(task_init)(jax.random.split(key, len(xs)))
    tdata = tm.pack_task_data(xs, ys, dtype=F64, device="cpu")
    out = {}
    for method in ("chol", "sweep"):
        out[method] = tm.meta_fit_task_stack(
            tdata, tgp.source_gp_config(), num_steps=STEPS,
            mll_method=method,
            init_stack=convert.gp_params(convert.to_numpy_dict(init),
                                         device="cpu"))
    return jstack, out


def test_pack_task_data(meta):
    xs, ys = meta
    jd = jm.pack_task_data(xs, ys, dtype=jnp.float64)
    td = tm.pack_task_data(xs, ys, dtype=F64, device="cpu")
    for a, b in zip(td, jd):
        close(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["chol", "sweep"])
def test_meta_fit_matches(fitted, method):
    jstack, tstacks = fitted
    ts_ = tstacks[method]
    for a, b in zip(ts_.params, jstack.params):
        close(a, b)
    close(ts_.chol, jstack.chol)
    close(ts_.alpha, jstack.alpha)


@pytest.mark.parametrize("full_cov", [True, False])
def test_source_predict_through_convert(fitted, full_cov):
    jstack, tstacks = fitted
    P = np.random.default_rng(1).uniform(size=(6, 2))
    cfg_j, cfg_t = jgp.source_gp_config(), tgp.source_gp_config()
    jmean, jcov = jm.source_predict(jstack, cfg_j, jnp.asarray(P),
                                    full_cov=full_cov)
    conv = convert.source_stack(convert.to_numpy_dict(jstack), device="cpu")
    tP = torch.as_tensor(P, dtype=F64)
    for stack, rtol in ((conv, 1e-10), (tstacks["sweep"], 1e-8)):
        tmean, tcov = tm.source_predict(stack, cfg_t, tP, full_cov=full_cov)
        close(tmean, jmean, rtol=rtol)
        close(tcov, jcov, rtol=rtol, atol=1e-10)


def test_acq_state_and_posterior_diag(fitted):
    """The cached acquisition posterior of one study against the JAX one
    with the same target parameters and buffers."""
    jstack, _ = fitted
    rng = np.random.default_rng(12)
    n, M = 5, 3
    Xbuf = rng.uniform(size=(n, 2))
    ybuf = rng.normal(size=n)
    mask = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
    Xq = rng.uniform(size=(7, 2))
    tcfg_j, tcfg_t = jgp.target_gp_config(), tgp.target_gp_config()
    scfg_j, scfg_t = jgp.source_gp_config(), tgp.source_gp_config()
    jp = jm.TargetParams(raw_weights=jnp.asarray(rng.normal(size=M)),
                         gp=jgp.GPParams(jnp.asarray([0.2, -0.3]),
                                         jnp.asarray(-1.0),
                                         jnp.asarray(-3.0)))
    om, os_ = 0.4, 1.7

    @jax.jit
    def ref(jstack, jp):
        state = jm.acq_state_from_parts(jstack, scfg_j, tcfg_j, jp, Xbuf,
                                        ybuf, mask, om, os_, 1e-3)
        return state, jm.posterior_diag_from_state(jstack, scfg_j, tcfg_j,
                                                   state, Xbuf, Xq)

    jstate, (jmu, jvar) = ref(jstack, jp)
    T = lambda a: torch.as_tensor(np.array(a), dtype=F64)  # noqa: E731
    tstack = convert.source_stack(convert.to_numpy_dict(jstack),
                                  device="cpu")
    tp = convert.target_params(convert.to_numpy_dict(jp), device="cpu")
    tstate = tm.acq_state_from_parts(tstack, scfg_t, tcfg_t, tp, T(Xbuf),
                                     T(ybuf), T(mask), T(om), T(os_), 1e-3)
    close(tstate.v1, jstate.v1, rtol=1e-10)
    close(tstate.st.alpha, jstate.st.alpha, rtol=1e-10)
    tmu, tvar = tm.posterior_diag_from_state(tstack, scfg_t, tcfg_t, tstate,
                                             T(Xbuf), T(Xq))
    close(tmu, jmu, rtol=1e-10)
    close(tvar, jvar, rtol=1e-9)


def test_weights_and_pruning():
    w = np.array([1e-4, 0.2, 1.5, 3.0])
    std = np.array([1.0, 2.0, 0.5, 1.0])
    raw_t = tm.weights_inverse(torch.as_tensor(w, dtype=F64))
    close(raw_t, jm.weights_inverse(jnp.asarray(w)), rtol=1e-12)
    close(tm.weights_forward(raw_t), w, rtol=1e-10)
    assert (tm.significant_weights_mask(
        torch.as_tensor(w), torch.as_tensor(std), 1e-3).numpy()
        == np.asarray(jm.significant_weights_mask(w, std, 1e-3))).all()
    jp0 = jm.init_target_params(jgp.target_gp_config(), 4, 2, jnp.float64)
    tp0 = tm.init_target_params(tgp.target_gp_config(), 4, 2, F64, "cpu")
    close(tp0.raw_weights, jp0.raw_weights, rtol=1e-12)
    g = torch.Generator().manual_seed(0)
    ts_ = tm.sample_target_params(tgp.target_gp_config(), g, 4, 2, F64,
                                  batch_shape=(3, 5))
    assert ts_.raw_weights.shape == (3, 5, 4)
    assert ts_.gp.raw_lengthscale.shape == (3, 5, 2)
    assert torch.isfinite(ts_.raw_weights).all()
