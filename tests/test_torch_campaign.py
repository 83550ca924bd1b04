"""Port parity: one lock-step campaign iteration as a whole, and the Branin
adapters, against the JAX package in float64.

From the same source stack, buffers, restart draws and raw candidates, the
JAX module-level ``_fit_target``, ``_study_acq_state`` and
``_study_posterior_diag_fast`` (vmapped over studies, as the reference
campaign runs them) and the reference's UCB ascent give the same target
parameters, posterior and proposal as the port, at rtol 1e-6.

The fits run 12 L-BFGS steps: on these nearly flat target objectives,
longer runs amplify roundoff-level differences between two correct
implementations (the port's own chol and sweep routes drift apart over 60
steps), which would test the line search's sensitivity, not the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scamlgp_tpu.benchmarking import jax_adapters as ja
from scamlgp_tpu.benchmarking.benchmarks import Branin as JBranin
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.parallel import campaign as jc
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin as TBranin
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.parallel import campaign as tc

F64 = torch.float64
S, M, NPTS, E = 2, 2, 8, 4
CFG = dict(fit_steps=12, acq_raw_samples=32, acq_topk=3, acq_steps=8)


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(a, b, rtol=1e-6, atol=1e-9):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def inputs():
    j = ja.campaign_inputs_from_benchmark(JBranin, [NPTS] * M, range(S),
                                          noise_std=1.0, dtype=jnp.float64)
    t = ta.campaign_inputs_from_benchmark(TBranin, [NPTS] * M, range(S),
                                          noise_std=1.0, dtype=F64,
                                          device="cpu")
    return j, t


def test_campaign_inputs_match(inputs):
    """Seeded meta-data agree exactly; the target task is unseeded by design
    (a fresh draw per benchmark instance), so each side's optimum is held
    against its own task: SHGO's minimum lies at or below a dense grid's."""
    (jfn, _, jmd, _), (tfn, ttp, tmd, topt) = inputs
    for a, b in zip(tmd, jmd):
        close(a, b, rtol=1e-12, atol=1e-14)
    g = np.linspace(0.0, 1.0, 201)
    grid = T(np.stack(np.meshgrid(g, g), -1).reshape(-1, 2))
    for s in range(S):
        vals = tfn(grid, {k: v[s] for k, v in ttp.items()})
        assert float(topt[s]) <= vals.min().item() + 1e-9
        assert vals.min().item() - float(topt[s]) < 0.05
    x = np.random.default_rng(0).uniform(size=(S, 2))
    jy = jax.vmap(jfn)(jnp.asarray(x), {k: jnp.asarray(v.numpy())
                                        for k, v in ttp.items()})
    close(tfn(T(x), ttp), jy, rtol=1e-12)


@pytest.fixture(scope="module")
def iteration(inputs):
    """Everything an iteration consumes, made on the JAX side, and the JAX
    results, for iteration 0 (empty buffers) and iteration 2."""
    (jfn, jtp, jmd, _), _ = inputs
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()
    flat = jm.TaskData(*[l.reshape((S * M,) + l.shape[2:]) for l in jmd])
    fs = jm.meta_fit_task_stack(flat, scfg, jax.random.PRNGKey(1),
                                num_restarts=2, num_steps=15)
    jstack = jax.tree_util.tree_map(
        lambda l: l.reshape((S, M) + l.shape[1:]), fs)
    rng = np.random.default_rng(2)
    Xbuf = np.zeros((S, E, 2))
    Xbuf[:, :2] = rng.uniform(size=(S, 2, 2))
    yclean = np.asarray(jax.vmap(jax.vmap(jfn, (0, None)))(
        jnp.asarray(Xbuf), jtp))
    ybuf = (yclean + rng.normal(size=(S, E))) * (np.arange(E) < 2)
    mask = (np.arange(E) < 2) * np.ones((S, E))
    bufs = {0: (np.zeros_like(Xbuf), np.zeros_like(ybuf),
                np.zeros_like(mask)),
            2: (Xbuf, ybuf, mask)}
    keys = jax.random.split(jax.random.PRNGKey(5), S)
    cfg = jc.CampaignConfig(**CFG)
    restarts = jax.vmap(lambda k: jax.vmap(lambda kk: jm.sample_target_params(
        tcfg, kk, M, 2, jnp.float64))(jax.random.split(k, cfg.fit_restarts)))(
            keys)
    raw = jax.random.uniform(jax.random.PRNGKey(6),
                             (S, cfg.acq_raw_samples, 2), jnp.float64)
    warm = jm.TargetParams(
        raw_weights=jm.weights_inverse(jnp.full((S, M), 1.0 / M)),
        gp=jax.vmap(lambda _: jgp.init_params(tcfg, 2, jnp.float64))(
            jnp.arange(S)))
    run = jax.jit(_jax_iteration)
    ref = {i: run(jstack, warm, *(jnp.asarray(a) for a in b), keys, raw)
           for i, b in bufs.items()}
    return dict(jstack=jstack, bufs=bufs, keys=keys, restarts=restarts,
                raw=raw, warm=warm, ref=ref)


def _jax_iteration(jstack, warm, Xbuf, ybuf, mask, keys, raw,
                   mll_method="chol"):
    """The reference's refit and acquisition state, vmapped over studies as
    its campaign runs them, and its ascent."""
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()
    cfg = jc.CampaignConfig(mll_method=mll_method, **CFG)
    om, os_ = jax.vmap(jc._out_transform)(jstack, ybuf, mask)
    # the fit draws its restarts from the keys exactly as the fixture does
    params = jax.vmap(lambda st, w, xb, yb, mk, o, s, k: jc._fit_target(
        st, scfg, tcfg, w, xb, yb, mk, o, s, k, cfg))(
            jstack, warm, Xbuf, ybuf, mask, om, os_, keys)
    state = jax.vmap(lambda st, p, xb, yb, mk, o, s: jc._study_acq_state(
        st, scfg, tcfg, p, xb, yb, mk, o, s, cfg.pruning_threshold))(
            jstack, params, Xbuf, ybuf, mask, om, os_)
    vals, x = jax.vmap(lambda st, s, xb, r: _jax_proposal(st, s, xb, r, cfg))(
        jstack, state, Xbuf, raw)
    return dict(out_mean=om, out_std=os_, params=params, ucb=vals, x=x)


def _jax_proposal(jstack, state, Xbuf, raw, cfg):
    """The reference campaign's acquisition ascent (``parallel/campaign.py``
    ``study_iteration``), for one study."""
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()

    def acq(x):
        mu, var = jc._study_posterior_diag_fast(jstack, scfg, tcfg, state,
                                                Xbuf, x[None])
        return (-mu[0] + jnp.sqrt(cfg.ucb_beta)
                * jnp.sqrt(jnp.maximum(var[0], 1e-30)))

    raw_vals = jax.vmap(acq)(raw)
    top = jax.lax.top_k(jnp.where(jnp.isfinite(raw_vals), raw_vals,
                                  -jnp.inf), cfg.acq_topk)[1]
    opt = optax.adam(cfg.acq_lr)

    def ascend(x0):
        u = jnp.clip(x0, 1e-6, 1 - 1e-6)
        z0 = jnp.log(u) - jnp.log1p(-u)
        neg = lambda z: -acq(jax.nn.sigmoid(z))  # noqa: E731

        def step(carry, _):
            z, s, bz, bv = carry
            v, g = jax.value_and_grad(neg)(z)
            updates, s = opt.update(g, s, z)
            better = jnp.isfinite(v) & (v < bv)
            return (optax.apply_updates(z, updates), s,
                    jnp.where(better, z, bz), jnp.where(better, v, bv)), None

        (zf, _, bz, bv), _ = jax.lax.scan(
            step, (z0, opt.init(z0), z0, jnp.asarray(jnp.inf)), None,
            length=cfg.acq_steps)
        vf = neg(zf)
        better = jnp.isfinite(vf) & (vf < bv)
        return jnp.where(better, zf, bz), jnp.where(better, vf, bv)

    zs, negv = jax.vmap(ascend)(raw[top])
    best = jnp.argmin(jnp.where(jnp.isfinite(negv), negv, jnp.inf))
    return raw_vals, jax.nn.sigmoid(zs[best])


@pytest.mark.parametrize("i", [0, 2])
@pytest.mark.parametrize("method", ["chol", "sweep"])
def test_one_lock_step_iteration_matches(iteration, method, i):
    """At i = 0 the MAP fit has only priors (the weights fall to their lower
    bound) and the buffers are all padding; at i = 2 two points are seen."""
    it, ref = iteration, iteration["ref"][i]
    scfg_t, tcfg_t = tgp.source_gp_config(), tgp.target_gp_config()
    cfg_t = tc.CampaignConfig(mll_method=method, **CFG)
    tstack = convert.source_stack(convert.to_numpy_dict(it["jstack"]),
                                  device="cpu")
    tX, ty, tmk = (T(a) for a in it["bufs"][i])
    om_t, os_t = tm.output_normalizer(tstack, ty, tmk)
    close(om_t, ref["out_mean"], rtol=1e-12)
    close(os_t, ref["out_std"], rtol=1e-12)
    restarts = convert.target_params(convert.to_numpy_dict(it["restarts"]),
                                     device="cpu")
    warm = convert.target_params(convert.to_numpy_dict(it["warm"]),
                                 device="cpu")
    tparams = tc._fit_target(tstack, scfg_t, tcfg_t, warm, tX, ty, tmk, om_t,
                             os_t, restarts, cfg_t)
    jparams = convert.target_params(convert.to_numpy_dict(ref["params"]),
                                    device="cpu")
    close(tfit.flatten(tparams, 1), tfit.flatten(jparams, 1))
    tstate = tc._study_acq_state(tstack, scfg_t, tcfg_t, tparams, tX, ty, tmk,
                                 om_t, os_t, cfg_t.pruning_threshold)
    tmu, tvar = tc._study_posterior_diag_fast(tstack, scfg_t, tcfg_t, tstate,
                                              tX, T(it["raw"]))
    ucb = -tmu + 3.0 * torch.sqrt(torch.clamp_min(tvar, 1e-30))
    close(ucb, ref["ucb"])
    tx = tc._propose(tstack, scfg_t, tcfg_t, tstate, tX, T(it["raw"]), cfg_t)
    close(tx, ref["x"])


def test_tiny_campaign_chol_and_sweep_agree(inputs):
    """S=2, M=2, N=8, E=3 on the CPU in float64: both MLL routes propose the
    same points."""
    _, (fn, tp, md, opt) = inputs
    cfg = tc.CampaignConfig(n_evaluations=3, **CFG)
    out = {}
    for method in ("chol", "sweep"):
        out[method] = tc.run_campaign(
            fn, tp, md, seed=0, cfg=dataclasses.replace(cfg,
                                                        mll_method=method),
            meta_fit_restarts=2, meta_fit_steps=15, meta_fit_chunks=2,
            device="cpu")
    a, b = out["chol"], out["sweep"]
    assert a.X.shape == (S, 3, 2) and len(a.iteration_seconds) == 3
    # the CPU runs the plain versions: no kernel launches, for any kernel
    assert a.launches["sweep_inverse"] == [0, 0, 0, 0]
    assert all(c == [0, 0, 0, 0] for c in a.launches.values())
    assert ((a.X >= 0) & (a.X <= 1)).all()
    close(a.X, b.X.numpy(), rtol=1e-8, atol=1e-10)
    close(a.y_clean, b.y_clean.numpy(), rtol=1e-8, atol=1e-10)
    reg = tc.simple_regret(a.y_clean, opt)
    assert torch.isfinite(reg).all() and (reg[:, 1:] <= reg[:, :-1]).all()


def test_meta_fit_chunks_do_not_change_the_fit(inputs):
    _, (fn, tp, md, _) = inputs
    cfg = tc.CampaignConfig(n_evaluations=1, **CFG)
    xs = [tc.run_campaign(fn, tp, md, seed=4, cfg=cfg, meta_fit_restarts=1,
                          meta_fit_steps=8, meta_fit_chunks=c,
                          device="cpu").X for c in (1, 2)]
    assert torch.equal(xs[0], xs[1])


def test_simple_regret_matches():
    y = np.random.default_rng(3).normal(size=(3, 6))
    opt = np.array([-1.0, 0.0, 0.5])
    close(tc.simple_regret(T(y), T(opt)), jc.simple_regret(y, opt),
          rtol=1e-12)


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(loop="device"),
                                    dict(cfg=tc.CampaignConfig(
                                        fit_method="hmc"))])
def test_unported_options_raise(inputs, kwargs):
    _, (fn, tp, md, _) = inputs
    with pytest.raises(NotImplementedError):
        tc.run_campaign(fn, tp, md, device="cpu", **kwargs)


def test_entry_points_default_to_cuda(inputs):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, (fn, tp, md, _) = inputs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_campaign(fn, tp, md)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.campaign_inputs_from_benchmark(TBranin, [4], [0], noise_std=0.1)
