"""Port parity: kernels, masked linear algebra, standardize, constraints and
priors of ``scamlgp_tpu_torch`` against the JAX package, float64 on the CPU,
same numpy inputs.  Deterministic functions agree to rtol 1e-10."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.ops import kernels as jk
from scamlgp_tpu.ops import linalg as jl
from scamlgp_tpu.utils import constraints as jc
from scamlgp_tpu.utils import priors as jp
from scamlgp_tpu.utils import standardize as js
from scamlgp_tpu_torch.ops import kernels as tk
from scamlgp_tpu_torch.ops import linalg as tl
from scamlgp_tpu_torch.utils import constraints as tc
from scamlgp_tpu_torch.utils import priors as tp
from scamlgp_tpu_torch.utils import standardize as ts
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-10


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(a, b, rtol=RTOL, atol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def torch_grad(fn, *args):
    ts_ = [T(a).requires_grad_(True) for a in args]
    out = fn(*ts_)
    grads = torch.autograd.grad(out, ts_)
    return out, grads


@pytest.fixture
def data():
    rng = np.random.default_rng(11)
    return dict(x=rng.uniform(size=(3, 7, 2)), z=rng.uniform(size=(3, 5, 2)),
                ls=rng.uniform(0.2, 1.5, size=(3, 2)),
                os=rng.uniform(0.5, 2.0, size=(3,)),
                w=rng.normal(size=(3, 7, 5)))


@pytest.mark.parametrize("name", ["rbf", "matern12", "matern32", "matern52"])
def test_gram_value_and_grad(data, name):
    def jfn(x, z, ls, os_):
        K = jax.vmap(lambda a, b, c, e: jk.gram(name, a, b, c, e))(
            x, z, ls, os_)
        return jnp.sum(K * data["w"])

    def tfn(x, z, ls, os_):
        return torch.sum(tk.gram(name, x, z, ls, os_) * T(data["w"]))

    args = (data["x"], data["z"], data["ls"], data["os"])
    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(*args)
    tv, tg = torch_grad(tfn, *args)
    close(tv, jv)
    for a, b in zip(tg, jg):
        close(a, b, atol=1e-10)


def test_sq_dist_matches(data):
    close(tk.sq_dist(T(data["x"]), T(data["z"]), T(data["ls"])),
          jax.vmap(jk.sq_dist)(data["x"], data["z"], data["ls"]))


def _masked_problem(seed=3, n=9):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(2, n, 2))
    y = rng.normal(size=(2, n))
    mask = np.ones((2, n))
    mask[0, 6:] = 0.0
    mask[1, 8:] = 0.0
    return X, y * mask, mask


def test_mask_system_matches():
    X, _, mask = _masked_problem()
    K = jax.vmap(lambda x: jk.rbf(x, x, jnp.array([0.4, 0.7]), 1.3))(X)
    noise = np.array([1e-3, 2e-2])
    A_j = jax.vmap(jl.mask_system)(K, noise, mask)
    A_t = tl.mask_system(T(K), T(noise), T(mask))
    close(A_t, A_j)
    close(tl.mask_system(T(K), T(noise), None),
          jax.vmap(lambda k, nz: jl.mask_system(k, nz, None))(K, noise))


def test_mll_value_and_grad_with_padding():
    X, y, mask = _masked_problem()
    mean = np.array([0.1, -0.2])[:, None] * np.ones_like(y)

    def jfn(ls, os_, noise):
        def one(x, yy, mk, mn, o, nz):
            K = jk.rbf(x, x, ls, o)
            return jl.mll(K, nz, yy, mk, mean=mn)
        return jnp.sum(jax.vmap(one)(X, y, mask, mean, os_, noise))

    def tfn(ls, os_, noise):
        K = tk.rbf(T(X), T(X), ls, os_)
        return torch.sum(tl.mll(K, noise, T(y), T(mask), mean=T(mean)))

    args = (np.array([0.5, 0.8]), np.array([1.1, 0.7]), np.array([1e-2, 3e-3]))
    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(*args)
    tv, tg = torch_grad(tfn, *args)
    close(tv, jv)
    for a, b in zip(tg, jg):
        close(a, b, atol=1e-9)


@pytest.mark.parametrize("full_cov", [True, False])
def test_posterior_matches(full_cov):
    X, y, mask = _masked_problem(seed=4)
    rng = np.random.default_rng(5)
    Xq = rng.uniform(size=(2, 4, 2))
    ls, os_, nz = np.array([0.5, 0.9]), 1.2, 1e-3
    K = jax.vmap(lambda x: jk.rbf(x, x, ls, os_))(X)
    Kxq = jax.vmap(lambda x, q: jk.rbf(x, q, ls, os_))(X, Xq)
    Kqq = jax.vmap(lambda q: jk.rbf(q, q, ls, os_))(Xq)
    st_j = jax.vmap(lambda k, yy, mk: jl.cholesky_factor(k, nz, yy, mk))(
        K, y, mask)
    st_t = tl.cholesky_factor(T(K), nz, T(y), T(mask))
    close(st_t.alpha, st_j.alpha)
    if full_cov:
        jm, jc_ = jax.vmap(lambda s, a, b: jl.posterior(s, a, Kqq=b))(
            st_j, Kxq, Kqq)
        tm, tc_ = tl.posterior(st_t, T(Kxq), Kqq=T(Kqq))
    else:
        diag = np.full((2, 4), os_)
        jm, jc_ = jax.vmap(lambda s, a, b: jl.posterior(s, a, Kqq_diag=b))(
            st_j, Kxq, diag)
        tm, tc_ = tl.posterior(st_t, T(Kxq), Kqq_diag=T(diag))
    close(tm, jm)
    close(tc_, jc_, atol=1e-11)


def test_cholesky_of_indefinite_is_nan():
    A = T(np.array([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]]))
    L = tl.cholesky(A)
    assert torch.isnan(L[0]).all()
    close(L[1], np.linalg.cholesky(np.asarray(A[1])))


@pytest.mark.parametrize("case", ["masked", "single", "constant", "dense"])
def test_fit_standardize(case):
    rng = np.random.default_rng(7)
    y = rng.normal(size=(4, 6)) * 3 + 1
    mask = np.ones((4, 6))
    if case == "masked":
        mask[:, 4:] = 0.0
    elif case == "single":
        mask[:, 1:] = 0.0
    elif case == "constant":
        y[:] = 2.5
    kw = {} if case == "dense" else dict(mask=mask)
    jr = js.fit_standardize(jnp.asarray(y), **{k: jnp.asarray(v)
                                               for k, v in kw.items()})
    tr = ts.fit_standardize(T(y), **{k: T(v) for k, v in kw.items()})
    close(tr.mean, jr.mean)
    close(tr.std, jr.std)
    close(tr.transform(T(y[:, 0])), jr.transform(jnp.asarray(y[:, 0])))


@pytest.mark.parametrize("kind", ["interval", "greater_than"])
def test_constraints_round_trip_and_grad(kind):
    raw = np.linspace(-6.0, 6.0, 13)
    if kind == "interval":
        jcn, tcn = jc.Interval(1e-4, 1e2), tc.Interval(1e-4, 1e2)
    else:
        jcn, tcn = jc.GreaterThan(1e-3), tc.GreaterThan(1e-3)
    close(tcn.forward(T(raw)), jcn.forward(jnp.asarray(raw)))
    val = np.asarray(jcn.forward(jnp.asarray(raw)))
    close(tcn.inverse(T(val)), jcn.inverse(jnp.asarray(val)), atol=1e-9)
    jg = jax.grad(lambda r: jnp.sum(jnp.log(jcn.forward(r))))(
        jnp.asarray(raw))
    _, (tg,) = torch_grad(lambda r: torch.sum(torch.log(tcn.forward(r))), raw)
    close(tg, jg)


PRIORS = [
    ("gamma", jp.Gamma(3.0, 6.0), tp.Gamma(3.0, 6.0)),
    ("gamma_lt1", jp.Gamma(0.5, 2.0), tp.Gamma(0.5, 2.0)),
    ("lognormal", jp.LogNormal(-2.0, 3.0), tp.LogNormal(-2.0, 3.0)),
    ("normal", jp.Normal(0.3, 1.7), tp.Normal(0.3, 1.7)),
    ("uniform", jp.Uniform(0.1, 2.0), tp.Uniform(0.1, 2.0)),
]


@pytest.mark.parametrize("name,jprior,tprior", PRIORS,
                         ids=[p[0] for p in PRIORS])
def test_prior_log_prob_and_grad(name, jprior, tprior):
    v = np.array([0.05, 0.3, 0.9, 1.7, 3.0])
    close(tprior.log_prob(T(v)), jprior.log_prob(jnp.asarray(v)))
    if name != "uniform":
        jg = jax.grad(lambda x: jnp.sum(jprior.log_prob(x)))(jnp.asarray(v))
        _, (tg,) = torch_grad(lambda x: torch.sum(tprior.log_prob(x)), v)
        close(tg, jg)


@pytest.mark.parametrize("name,jprior,tprior", PRIORS,
                         ids=[p[0] for p in PRIORS])
def test_prior_sample_moments(name, jprior, tprior):
    """Samplers agree in distribution (JAX keys and torch generators give
    different streams): the mean of log-draws of 40k samples within five
    standard errors of the JAX sampler's."""
    n = 40000
    g = torch.Generator().manual_seed(0)
    ts_ = tprior.sample(g, (n,), F64).numpy()
    js_ = np.asarray(jprior.sample(jax.random.PRNGKey(0), (n,)))
    f = (lambda a: a) if name == "normal" else np.log
    se = math.sqrt(np.var(f(js_)) / n + np.var(f(ts_)) / n)
    assert abs(np.mean(f(ts_)) - np.mean(f(js_))) < 5 * se
    assert ts_.dtype == np.float64
