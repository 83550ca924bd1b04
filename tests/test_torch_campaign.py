"""Port parity: one lock-step campaign iteration as a whole, and the Branin
adapters, against the JAX package in float64.

From the same source stack, buffers, restart draws and raw candidates, the
JAX module-level ``_fit_target``, ``_study_acq_state`` and
``_study_posterior_diag_fast`` (vmapped over studies, as the reference
campaign runs them) and the reference's UCB ascent give the same target
parameters, posterior and proposal as the port, at rtol 1e-6.  With a
posterior fit (``fit_method`` hmc, nuts, vi), the reference's
``_sample_target_hmc`` / ``_sample_target_vi`` on per-study fit keys and
its mixture UCB give the same mixture draws and acquisition values, at the
sampler tests' rtol 1e-8, and the same proposal as the port's
``run_iteration`` on draws that replay those keys.

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
from scamlgp_tpu.benchmarking.benchmarks.base import Base as JBase
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
from scamlgp_tpu_torch.parallel.mesh import Mesh, make_mesh
from tests import torch_posterior_case as case
from tests.torch_threads import one_thread  # noqa: F401

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


def seeded_targets(seeds) -> dict:
    """Branin target-task parameters, one task drawn from each seed.

    A benchmark draws its target task unseeded (a fresh task per instance,
    as in the reference), so buffers built on ``inputs``' targets held
    other data in every test process.  On rare tasks a posterior
    iteration's chains amplify roundoff past the samplers' rtol, the
    port's ``chol`` and ``sweep`` routes then about as far from each other
    as from the reference, and the test failed by chance.  The buffers are
    built on these tasks instead, the same in every process."""
    b = JBranin(n_data_per_task=[NPTS] * M, seed=0)
    tasks = [ja._task_param_dict(JBase.create_random_task(
        0, b._descriptors, b._settings, b._context, seed=s)) for s in seeds]
    return {k: jnp.asarray([t[k] for t in tasks], jnp.float64)
            for k in tasks[0]}


@pytest.fixture(scope="module")
def iteration(inputs):
    """Everything an iteration consumes, made on the JAX side, and the JAX
    results, for iteration 0 (empty buffers) and iteration 2 (two points of
    the seeded target tasks seen)."""
    (jfn, _, jmd, _), _ = inputs
    jtp = seeded_targets(range(S))
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

    return _jax_ascent(acq, raw, cfg)


def _jax_ascent(acq, raw, cfg):
    """The reference campaign's raw sweep and Adam ascent of ``acq`` (a
    function of one point), for one study: (raw values, proposal)."""
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


@pytest.mark.parametrize("i,fixed_trips", [(0, False), (2, False),
                                           (0, True), (2, True)],
                         ids=["0", "2", "0-fixed", "2-fixed"])
@pytest.mark.parametrize("method", ["chol", "sweep"])
def test_one_lock_step_iteration_matches(iteration, method, i, fixed_trips):
    """At i = 0 the MAP fit has only priors (the weights fall to their lower
    bound) and the buffers are all padding; at i = 2 two points are seen.
    With ``fixed_trips`` the fit is the device loop's (every line search
    to its cap of trips, no host sync)."""
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
                             os_t, restarts, cfg_t, fixed_trips)
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


@pytest.mark.parametrize("kwargs", [dict(mesh=object())])
def test_unported_options_raise(inputs, kwargs):
    """A mesh that is not a ``parallel.mesh.Mesh`` is refused."""
    _, (fn, tp, md, _) = inputs
    with pytest.raises(TypeError):
        tc.run_campaign(fn, tp, md, device="cpu", **kwargs)


@pytest.mark.parametrize("fit_method", ["map", "vi"])
def test_study_sharded_campaign_equals_unsharded(fit_method):
    """S=6 studies over a mesh of 4 study slots (padded to 8 with copies of
    study 0, the last slot all padding), each slot its rows on a ``cpu``
    slot, with a MAP and with a posterior (ADVI) fit.  The draws are made
    for all S and sliced, so each slot runs what a study chunk of its rows
    runs: the mesh equals ``study_chunk=2`` bit for bit.  It equals the
    unsharded campaign to 1e-12 only: a batch of 2 studies takes other
    vector tails than one of 6 in CPU kernels such as ``aten.sigmoid``,
    which moves a last bit of some runs' later proposals, as it does a
    chunked run's."""
    fn, tp, md, _ = ta.campaign_inputs_from_benchmark(
        TBranin, [6] * 2, range(6), noise_std=1.0, dtype=F64, device="cpu")
    cfg = tc.CampaignConfig(n_evaluations=2, fit_method=fit_method,
                            vi_steps=8, vi_mc=3, mixture_samples=4, **CFG)
    kw = dict(seed=1, cfg=cfg, meta_fit_restarts=1, meta_fit_steps=8,
              device="cpu")
    a = tc.run_campaign(fn, tp, md, **kw)
    chunked = tc.run_campaign(fn, tp, md, study_chunk=2, **kw)
    b = tc.run_campaign(fn, tp, md, mesh=make_mesh(study=4,
                                                   devices=["cpu"] * 4),
                        **kw)
    for f in ("X", "y", "y_clean", "mask"):
        assert torch.equal(getattr(chunked, f), getattr(b, f)), f
        close(getattr(b, f), getattr(a, f).numpy(), rtol=1e-12, atol=1e-12)
    for x, y in zip(tfit.tree_leaves(a.stack), tfit.tree_leaves(b.stack)):
        assert torch.equal(x, y)
    if fit_method == "vi":
        for x, y in zip(tfit.tree_leaves(chunked.samples),
                        tfit.tree_leaves(b.samples)):
            assert x.shape[0] == 6 and torch.equal(x, y)
    assert b.studies.tolist() == list(range(6))
    assert (b.mask == 1).all() and len(b.iteration_seconds) == 2


@pytest.mark.parametrize("kwargs,error", [
    (dict(study_chunk=1), ValueError),
    (dict(meta_fit_chunks=2), ValueError),
    (dict(checkpoint_path="unused", ranks=[0, 1]), NotImplementedError)])
def test_mesh_refuses(inputs, kwargs, error):
    """A mesh takes no study chunks and no meta-fit chunks (its rows split
    the studies), and no checkpoint over several processes (a process
    holds its own rows only)."""
    _, (fn, tp, md, _) = inputs
    kwargs = dict(kwargs)
    mesh = make_mesh(study=2, devices=["cpu"] * 2)
    if "ranks" in kwargs:
        mesh = Mesh(mesh.devices, ranks=kwargs.pop("ranks"), rank=0)
    with pytest.raises(error):
        tc.run_campaign(fn, tp, md, device="cpu", mesh=mesh, **kwargs)


def test_study_sharded_campaign_resumes(tmp_path):
    """A one-process mesh checkpoints as the unsharded campaign does: S=3
    over 2 study rows (one padded study), stopped after one iteration and
    resumed, equals the uninterrupted mesh run bit for bit."""
    fn, tp, md, _ = ta.campaign_inputs_from_benchmark(
        TBranin, [6] * 2, range(3), noise_std=1.0, dtype=F64, device="cpu")
    kw = dict(seed=2, cfg=tc.CampaignConfig(n_evaluations=2, **CFG),
              meta_fit_restarts=1, meta_fit_steps=8, device="cpu",
              mesh=make_mesh(study=2, devices=["cpu"] * 2))
    a = tc.run_campaign(fn, tp, md, **kw)
    ck = tmp_path / "mesh"
    first = tc.run_campaign(fn, tp, md, checkpoint_path=ck, stop_after=1,
                            **kw)
    assert first.mask.sum(-1).tolist() == [1.0] * 3
    b = tc.run_campaign(fn, tp, md, checkpoint_path=ck, **kw)
    for f in ("X", "y", "y_clean", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_entry_points_default_to_cuda(inputs):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, (fn, tp, md, _) = inputs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_campaign(fn, tp, md)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.campaign_inputs_from_benchmark(TBranin, [4], [0], noise_std=0.1)


# ---------------------------------------------------------------------------
# one lock-step iteration with a posterior fit (fit_method hmc, nuts, vi)
# ---------------------------------------------------------------------------

#: small samplers: 2 chains x (6 warmup + 4 samples), 3 leapfrog steps or
#: depth 3; ADVI 10 steps x 4 draws; a 4-draw mixture of 8 chain draws
POST = dict(CFG, hmc_chains=2, hmc_warmup=6, hmc_samples=4, hmc_leapfrog=3,
            hmc_max_depth=3, mixture_samples=4, vi_steps=10, vi_mc=4)
POST_RTOL = 1e-8   # the sampler tests' (tests/test_torch_hmc.py)


def _jax_posterior_iteration(jstack, warm, Xbuf, ybuf, mask, keys, raw,
                             fit_method):
    """The reference's posterior refit of every study from its fit key
    (``_sample_target_hmc`` / ``_sample_target_vi``), the draws' acquisition
    states, and the mixture UCB's raw sweep and ascent (``study_iteration``,
    ``campaign.py:542-570``), vmapped over studies."""
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()
    cfg = jc.CampaignConfig(fit_method=fit_method, **POST)
    om, os_ = jax.vmap(jc._out_transform)(jstack, ybuf, mask)

    def one(st, w, xb, yb, mk, o, s, k, r):
        if fit_method == "vi":
            samples = jc._sample_target_vi(st, scfg, tcfg, w, xb, yb, mk, o,
                                           s, k, cfg)
        else:
            samples = jc._sample_target_hmc(st, scfg, tcfg, xb, yb, mk, o, s,
                                            k, cfg)
        states = jax.vmap(lambda p: jc._study_acq_state(
            st, scfg, tcfg, p, xb, yb, mk, o, s, cfg.pruning_threshold))(
                samples)

        def acq(x):
            def draw(state):
                mu, var = jc._study_posterior_diag_fast(st, scfg, tcfg, state,
                                                        xb, x[None])
                return mu[0], var[0]

            mus, vars_ = jax.vmap(draw)(states)
            mean = jnp.mean(mus)
            var = jnp.mean(vars_ + mus ** 2) - mean ** 2
            return (-mean + jnp.sqrt(cfg.ucb_beta)
                    * jnp.sqrt(jnp.maximum(var, 1e-30)))

        return (samples,) + _jax_ascent(acq, r, cfg)

    samples, vals, x = jax.vmap(one)(jstack, warm, Xbuf, ybuf, mask, om, os_,
                                     keys, raw)
    return dict(samples=samples, ucb=vals, x=x)


def _replayed_draws(keys, raw, fit_method, d: int) -> tc.IterationDraws:
    """The port's iteration draws that replay the reference's fit keys: each
    study's chain starts and sampler draws (``campaign.py:202-205``), or its
    ADVI and mixture draws (``campaign.py:256-260``)."""
    cfg = tc.CampaignConfig(fit_method=fit_method, **POST)
    D = M + d + 2
    chains = None
    if fit_method == "vi":
        per = [case.vi_draws(k, cfg.vi_steps, cfg.vi_mc, cfg.mixture_samples,
                             D) for k in keys]
        sampler = tfit.tree_map(lambda *ls: torch.stack(ls), *per)
    else:
        C, T_ = cfg.hmc_chains, cfg.hmc_warmup + cfg.hmc_samples
        k_init, k_run = (k.reshape((S * C,) + k.shape[2:]) for k in
                         jax.vmap(lambda k: case.chain_keys(k, C))(keys))
        _, starts = case.target_inits(k_init, jgp.target_gp_config(), M, d)
        flat = (case.nuts_draws(k_run, T_, D, cfg.hmc_max_depth)
                if fit_method == "nuts" else case.hmc_draws(k_run, T_, D))
        chains, sampler = (tfit.tree_map(
            lambda leaf: leaf.reshape((S, C) + leaf.shape[1:]), tree)
            for tree in (starts, flat))
    return tc.IterationDraws(restarts=None, raw=T(raw),
                             noise=torch.zeros(S, dtype=F64), chains=chains,
                             sampler=sampler)


@pytest.mark.parametrize("method", ["chol", "sweep", "sweep-fixed"])
@pytest.mark.parametrize("fit_method", ["hmc", "nuts", "vi"])
def test_one_posterior_iteration_matches(inputs, iteration, fit_method,
                                         method):
    """Iteration 2 (two points seen) through the port's ``run_iteration``
    on draws that replay the reference's fit keys: the mixture draws (the
    chains interleaved sample-major and thinned from the tail, or ADVI's
    q draws), the carried last draw, the mixture UCB at the raw candidates
    and the proposal against the reference's, at the sampler tests' rtol
    (the proposal at the MAP iteration's).  ``sweep-fixed`` runs the
    device loop's body (``device_iteration``: NUTS transitions to their
    cap of steps, no host sync) on the sweep route, its draws read and its
    evaluation written at a device index."""
    method, _, fixed = method.partition("-")
    it = iteration
    _, (tfn, ttp, _, _) = inputs
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    Xbuf, ybuf, mask = it["bufs"][2]
    ref = jax.jit(_jax_posterior_iteration, static_argnums=7)(
        it["jstack"], it["warm"], *(jnp.asarray(a) for a in it["bufs"][2]),
        keys, it["raw"], fit_method)
    scfg_t, tcfg_t = tgp.source_gp_config(), tgp.target_gp_config()
    cfg_t = tc.CampaignConfig(fit_method=fit_method, mll_method=method,
                              **POST)
    tstack = convert.source_stack(convert.to_numpy_dict(it["jstack"]),
                                  device="cpu")
    warm = convert.target_params(convert.to_numpy_dict(it["warm"]),
                                 device="cpu")
    draws = _replayed_draws(keys, it["raw"], fit_method, 2)
    tX, ty, tmk = T(Xbuf), T(ybuf), T(mask)
    if fixed:
        params = tfit.tree_map(torch.clone, warm)
        bufs = [tX.clone(), ty.clone(), torch.zeros_like(ty), tmk.clone()]
        samples = tc.device_iteration(
            tfn, tstack, ttp, bufs, params, tc._stack_draws([draws] * 3),
            torch.tensor([2]), scfg_t, tcfg_t, cfg_t)
        out = bufs
    else:
        out = tc.run_iteration(tfn, tstack, ttp, tX, ty,
                               torch.zeros_like(ty), tmk, warm, draws, 2,
                               scfg_t, tcfg_t, cfg_t)
        params, samples = out[4], out[5]
    jsamples = convert.target_params(convert.to_numpy_dict(ref["samples"]),
                                     device="cpu")
    assert samples.raw_weights.shape == (S, POST["mixture_samples"], M)
    close(tfit.flatten(samples, 2), tfit.flatten(jsamples, 2),
          rtol=POST_RTOL, atol=1e-12)
    close(tfit.flatten(params, 1), tfit.flatten(jsamples, 2)[:, -1],
          rtol=POST_RTOL, atol=1e-12)
    om, os_ = tm.output_normalizer(tstack, ty, tmk)
    stack_a, X_a, *rest = tc._with_draw_axis(tstack, tX, ty, tmk, om, os_)
    state = tc._study_acq_state(stack_a, scfg_t, tcfg_t, samples, X_a, *rest,
                                cfg_t.pruning_threshold)
    ucb = tc._acquisition(stack_a, scfg_t, tcfg_t, state, X_a, cfg_t,
                          mixture=True)(T(it["raw"]))
    close(ucb, ref["ucb"], rtol=POST_RTOL, atol=1e-12)
    close(out[0][:, 2], ref["x"])
