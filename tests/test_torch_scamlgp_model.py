"""Port parity: the ScaML-GP target model (``models/scamlgp.py``: the
normalizer and cached source moments of ``build_scamlgp``, the MAP
objective, the posteriors, ``fit_scamlgp``, ``meta_fit_scamlgp`` and
``validate_meta_data``) against the JAX package in float64 on the CPU.

Random draws are the JAX ones, handed to the port as ``init_stack``.
Tolerances: rtol 1e-8 where the two packages evaluate the same expression;
rtol 1e-6 for fits, whose L-BFGS amplifies roundoff over the steps.
"""

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

F64 = torch.float64
D, RESTARTS, META_STEPS = 2, 2, 15


def close(a, b, rtol=1e-8, atol=1e-10):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def meta():
    rng = np.random.default_rng(21)
    xs = [rng.uniform(size=(n, D)) for n in (9, 6, 8)]
    ys = [np.cos(3 * x[:, 0]) * (i + 1) - x[:, 1] + 0.05 * rng.normal(
        size=len(x)) for i, x in enumerate(xs)]
    return xs, ys


def jax_meta_init(key, num_tasks):
    """The restart stack ``meta_fit_task_stack`` draws from ``key``."""
    cfg = jgp.source_gp_config()
    warm = jgp.init_params(cfg, D, jnp.float64)

    def task_init(task_key):
        keys = jax.random.split(task_key, RESTARTS)
        sampled = jax.vmap(lambda k: jgp.sample_params(
            cfg, k, D, jnp.float64))(keys)
        return jfit.stack_restarts(warm, sampled)

    return jax.vmap(task_init)(jax.random.split(key, num_tasks))


@pytest.fixture(scope="module")
def stacks(meta):
    xs, ys = meta
    key = jax.random.PRNGKey(5)
    jstack, _ = jm.meta_fit_scamlgp(xs, ys, key=key,
                                    num_restarts_log_likelihood=RESTARTS,
                                    num_steps=META_STEPS,
                                    dtype=jnp.float64)
    init = convert.gp_params(convert.to_numpy_dict(jax_meta_init(key, 3)),
                             device="cpu")
    tstack, _ = tm.meta_fit_scamlgp(xs, ys,
                                    num_restarts_log_likelihood=RESTARTS,
                                    num_steps=META_STEPS, device="cpu",
                                    init_stack=init)
    return jstack, tstack


@pytest.fixture(scope="module")
def target():
    """Target buffers padded to 8 with 5 observations, and parameters away
    from the warm start."""
    rng = np.random.default_rng(4)
    X = np.zeros((8, D))
    y = np.zeros(8)
    mask = np.zeros(8)
    X[:5] = rng.uniform(size=(5, D))
    y[:5] = np.cos(3 * X[:5, 0]) * 1.5 - X[:5, 1]
    mask[:5] = 1.0
    params = jm.TargetParams(
        raw_weights=jnp.asarray([0.3, -0.8, 0.1]),
        gp=jgp.GPParams(jnp.asarray([0.4, -0.2]), jnp.asarray(-1.5),
                        jnp.asarray(-4.0)))
    return X, y, mask, params


def build_both(stacks, target, empty=False):
    jstack, tstack = stacks
    X, y, mask, params = target
    if empty:
        mask = np.zeros_like(mask)
    jmodel = jm.build_scamlgp(jstack, jgp.source_gp_config(),
                              jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(mask), params=params)
    tparams = convert.target_params(convert.to_numpy_dict(params),
                                    device="cpu")
    tmodel = tm.build_scamlgp(tstack, tgp.source_gp_config(), t(X), t(y),
                              t(mask), params=tparams)
    return jmodel, tmodel


def test_meta_fit_scamlgp_matches(stacks):
    jstack, tstack = stacks
    for a, b in zip(tstack.params, jstack.params):
        close(a, b, rtol=1e-6)
    close(tstack.chol, jstack.chol, rtol=1e-6, atol=1e-9)
    close(tstack.alpha, jstack.alpha, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("empty", [False, True], ids=["padded", "empty"])
def test_build_scamlgp_normalizer_and_cached_moments(stacks, target, empty):
    """On the converted JAX stack, so that only ``build_scamlgp`` differs."""
    jstack, _ = stacks
    jmodel, _ = build_both(stacks, target, empty)
    X, y, mask, params = target
    mask = np.zeros_like(mask) if empty else mask
    tmodel = tm.build_scamlgp(
        convert.source_stack(convert.to_numpy_dict(jstack), device="cpu"),
        tgp.source_gp_config(), t(X), t(y), t(mask))
    close(tmodel.out_mean, jmodel.out_mean, rtol=1e-12)
    close(tmodel.out_std, jmodel.out_std, rtol=1e-12)
    if empty:
        assert float(tmodel.out_mean) == 0.0 and float(tmodel.out_std) == 1.0
    close(tmodel.cached_source_means, jmodel.cached_source_means)
    close(tmodel.cached_source_covs, jmodel.cached_source_covs)
    # without params the weights start at 1/M
    close(tmodel.weights, np.full(3, 1.0 / 3), rtol=1e-12)
    assert tmodel.num_tasks == 3


def test_convert_scamlgp_model_round_trip(stacks, target):
    jmodel, _ = build_both(stacks, target)
    tmodel = convert.scamlgp_model(convert.to_numpy_dict(jmodel),
                                   device="cpu")
    for a, b in zip(convert.to_numpy_dict(tmodel).values(),
                    convert.to_numpy_dict(jmodel).values()):
        if isinstance(a, dict):
            continue
        close(a, b, rtol=0, atol=0)
    close(tmodel.source.chol, jmodel.source.chol, rtol=0, atol=0)
    close(tmodel.params.gp.raw_noise, jmodel.params.gp.raw_noise, rtol=0,
          atol=0)


def test_map_objective_value_and_gradient(stacks, target):
    """One parameter set and a stack of three restarts: values and the
    gradient with respect to every raw parameter, on one converted model."""
    jmodel, _ = build_both(stacks, target)
    tmodel = convert.scamlgp_model(convert.to_numpy_dict(jmodel),
                                   device="cpu")
    cfg_j, cfg_t = jgp.target_gp_config(), tgp.target_gp_config()
    rng = np.random.default_rng(9)
    stack = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(np.asarray(leaf) + 0.3 * rng.normal(
            size=(3,) + np.shape(leaf))), jmodel.params)

    def jobj(p):
        return jm.scamlgp_map_objective(jmodel, cfg_j, p)

    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jobj)))(stack)
    tstack = convert.target_params(convert.to_numpy_dict(stack),
                                   device="cpu")
    leaves = [tstack.raw_weights, *tstack.gp]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tv = tm.scamlgp_map_objective(tmodel, cfg_t, tstack)
    tg = torch.autograd.grad(tv.sum(), leaves)
    close(tv, jv)
    for a, b in zip(tg, [jg.raw_weights, *jg.gp]):
        close(a, b)
    # one parameter set, no restart axis
    single = convert.target_params(convert.to_numpy_dict(jmodel.params),
                                   device="cpu")
    close(tm.scamlgp_map_objective(tmodel, cfg_t, single),
          jobj(jmodel.params))


@pytest.mark.parametrize("observation_noise,original_scale",
                         [(False, True), (True, False)])
def test_posterior_mean_and_cov(stacks, target, observation_noise,
                                original_scale):
    jmodel, _ = build_both(stacks, target)
    tmodel = convert.scamlgp_model(convert.to_numpy_dict(jmodel),
                                   device="cpu")
    Xq = np.random.default_rng(2).uniform(size=(6, D))
    args = (jgp.source_gp_config(), jgp.target_gp_config())
    jmean, jcov = jax.jit(lambda model, xq: jm.scamlgp_posterior(
        model, *args, xq, observation_noise=observation_noise,
        original_scale=original_scale))(jmodel, jnp.asarray(Xq))
    tmean, tcov = tm.scamlgp_posterior(
        tmodel, tgp.source_gp_config(), tgp.target_gp_config(), t(Xq),
        observation_noise=observation_noise, original_scale=original_scale)
    close(tmean, jmean)
    close(tcov, jcov)


@pytest.mark.parametrize("form", ["joint", "cached"])
def test_posterior_diag(stacks, target, form):
    jmodel, _ = build_both(stacks, target)
    tmodel = convert.scamlgp_model(convert.to_numpy_dict(jmodel),
                                   device="cpu")
    Xq = np.random.default_rng(3).uniform(size=(7, D))
    scfg_j, tcfg_j = jgp.source_gp_config(), jgp.target_gp_config()
    scfg_t, tcfg_t = tgp.source_gp_config(), tgp.target_gp_config()
    jmean, jvar = jax.jit(lambda model, xq: jm.scamlgp_posterior_diag(
        model, scfg_j, tcfg_j, xq))(jmodel, jnp.asarray(Xq))
    if form == "joint":
        tmean, tvar = tm.scamlgp_posterior_diag(tmodel, scfg_t, tcfg_t,
                                                t(Xq))
    else:
        state = tm.scamlgp_acq_state(tmodel, scfg_t, tcfg_t)
        tmean, tvar = tm.scamlgp_posterior_diag_cached(
            tmodel, scfg_t, tcfg_t, state, t(Xq))
    close(tmean, jmean)
    close(tvar, jvar)


def test_fit_scamlgp_from_jax_restarts(stacks, target):
    """``fit_scamlgp`` from the JAX restart draws, 20 L-BFGS steps."""
    jmodel, _ = build_both(stacks, target)
    tmodel = convert.scamlgp_model(convert.to_numpy_dict(jmodel),
                                   device="cpu")
    cfg_j = jgp.target_gp_config()
    key = jax.random.PRNGKey(17)
    R, steps = 2, 20
    jfitted = jm.fit_scamlgp(jmodel, cfg_j, key, num_restarts=R,
                             num_steps=steps)
    keys = jax.random.split(key, R)
    sampled = jax.vmap(lambda k: jm.sample_target_params(
        cfg_j, k, 3, D, jnp.float64))(keys)
    init = jfit.stack_restarts(jmodel.params, sampled)
    tfitted = tm.fit_scamlgp(
        tmodel, tgp.target_gp_config(), num_steps=steps,
        init_stack=convert.target_params(convert.to_numpy_dict(init),
                                         device="cpu"))
    close(tfitted.params.raw_weights, jfitted.params.raw_weights, rtol=1e-6,
          atol=1e-8)
    for a, b in zip(tfitted.params.gp, jfitted.params.gp):
        close(a, b, rtol=1e-6, atol=1e-8)
    assert tfitted.train_X is tmodel.train_X


def test_fit_scamlgp_draws_from_the_generator(stacks, target):
    """Without ``init_stack`` the restarts come from the generator: one
    seed gives one fit."""
    _, tmodel = build_both(stacks, target)
    cfg = tgp.target_gp_config()
    fits = [tm.fit_scamlgp(tmodel, cfg,
                           torch.Generator().manual_seed(3), num_restarts=2,
                           num_steps=5) for _ in range(2)]
    for a, b in zip(fits[0].params.gp, fits[1].params.gp):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(fits[0].params.raw_weights).all())


BAD_META = {
    "empty": ([], []),
    "task_counts": ([np.zeros((2, 2))], [np.zeros(2), np.zeros(2)]),
    "feature_dim": ([np.zeros((2, 2)), np.zeros((2, 3))],
                    [np.zeros(2), np.zeros(2)]),
    "output_dim": ([np.zeros((2, 2))], [np.zeros((2, 2))]),
    "lengths": ([np.zeros((3, 2))], [np.zeros(2)]),
}


@pytest.mark.parametrize("case", sorted(BAD_META))
def test_validate_meta_data_errors(case):
    xs, ys = BAD_META[case]
    with pytest.raises(ValueError) as jerr:
        jm.validate_meta_data(xs, ys)
    with pytest.raises(ValueError) as terr:
        tm.validate_meta_data(xs, ys)
    assert str(terr.value) == str(jerr.value)


def test_validate_meta_data_accepts_column_outputs():
    xs = [np.zeros((3, 2)), np.ones((2, 2))]
    tm.validate_meta_data(xs, [np.zeros((3, 1)), np.zeros(2)])
