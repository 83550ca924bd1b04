"""Port parity: the blocked-Cholesky inverse and the mid-N route it serves.

In float64 on the CPU, where the port's wrapper runs its plain version:

- ``blocked_chol_inverse_reference`` against the JAX kernel
  ``pallas_blocked_chol.blocked_chol_inverse`` run in interpret mode, in both
  of its TPU variants (the HBM-staged one forced as
  ``tests/test_blocked_chol.py`` forces it), rtol 1e-10;
- ``mll_via_inverse(..., route_blocked=True)`` value and gradient against the
  JAX ``mll_via_inverse`` with ``_ROUTE_BLOCKED`` on, rtol 1e-9;
- ``gp.mll`` on the blocked route: the value against the JAX value under
  the same flag (rtol 1e-10), the gradient against the ``"chol"`` gradients
  of the port and of the JAX package (rtol 1e-7; the JAX blocked route has
  no working gradient, ROADMAP queue 3);
- a short meta-fit and one lock-step iteration on the blocked route against
  the JAX package's ``"chol"`` route, rtol 1e-6;
- the routing predicates against the JAX ones;
- the Hartmann adapters against ``jax_adapters``.

The CUDA kernels are held against the plain version in
``tests/test_torch_cuda.py``, on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scamlgp_tpu.ops.pallas_blocked_chol as pbc
from scamlgp_tpu.benchmarking import jax_adapters as ja
from scamlgp_tpu.benchmarking.benchmarks import Hartmann6D as JHartmann6D
from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.ops import inverse_mll as jim
from scamlgp_tpu.parallel import campaign as jc
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    Hartmann6D as THartmann6D,
)
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.ops import blocked_chol as tbc
from scamlgp_tpu_torch.ops import inverse_mll as tim
from scamlgp_tpu_torch.parallel import campaign as tc
from tests.test_torch_campaign import CFG, _jax_iteration
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _spd_batch(rng, b, n, jitter=0.5):
    X = rng.normal(size=(b, n, n))
    return np.einsum("bij,bkj->bik", X, X) / n + jitter * np.eye(n)


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the plain blocked version (the CPU's route)."""
    calls = []
    plain = tbc.blocked_chol_inverse_reference

    def spy(A):
        calls.append(tuple(A.shape))
        return plain(A)

    monkeypatch.setattr(tbc, "blocked_chol_inverse_reference", spy)
    return calls


@pytest.mark.parametrize("n", [64, 88, 128, 192])
def test_plain_blocked_matches_pallas_kernel(n):
    """n = 88 pads with an identity block; the JAX kernel runs its
    VMEM-resident variant (``_make_kernel``) here."""
    A = _spd_batch(np.random.default_rng(n), 3, n)
    assert pbc._choose_g(3, n, 8) >= 1
    inv_j, ld_j = pbc.blocked_chol_inverse(jnp.asarray(A))
    inv_t, ld_t = tbc.blocked_chol_inverse(T(A))   # CPU: plain version
    assert inv_t.shape == (3, n, n) and ld_t.shape == (3,)
    close(inv_t, inv_j, rtol=1e-10, atol=1e-12)
    close(ld_t, ld_j, rtol=1e-10)


@pytest.mark.parametrize("n", [88, 128])
def test_plain_blocked_matches_pallas_hbm_staged_variant(n, monkeypatch):
    """The JAX kernel's HBM-staged variant (``_make_hbm_kernel``), forced by
    shrinking the VMEM budget as ``test_hbm_staged_variant_matches_numpy``
    does."""
    need_hbm = (128 * 128 + (3 * 2 * 3 // 2 + 4) * pbc.BS * pbc.BS) * 4
    monkeypatch.setattr(pbc, "_VMEM_BUDGET", need_hbm + 1024)
    assert pbc._choose_g(3, n, 8) < 1 and pbc._hbm_staged_fits(n, 8)
    A = _spd_batch(np.random.default_rng(n + 7), 3, n)
    inv_j, ld_j = pbc.blocked_chol_inverse(jnp.asarray(A))
    inv_t, ld_t = tbc.blocked_chol_inverse(T(A))
    close(inv_t, inv_j, rtol=1e-10, atol=1e-12)
    close(ld_t, ld_j, rtol=1e-10)


def test_plain_blocked_of_indefinite_matrix_is_not_finite():
    """No clamping: a non-positive pivot gives a NaN log-determinant and a
    NaN inverse."""
    A = np.eye(70)
    A[0, 1] = A[1, 0] = 2.0
    inv, ld = tbc.blocked_chol_inverse(T(A[None]))
    assert torch.isnan(ld).all() and not torch.isfinite(inv).all()


@pytest.mark.parametrize("n", [192, 256])
def test_mll_via_inverse_blocked_route(n, monkeypatch, counted):
    """Value and gradient in A, y and a batch-shaped n_active (the scalar
    form hits the reference's VJP fault)."""
    monkeypatch.setattr(pbc, "_ROUTE_BLOCKED", True)
    rng = np.random.default_rng(n)
    b = 2
    A = _spd_batch(rng, b, n)
    y = rng.normal(size=(b, n))
    n_active = np.full((b,), float(n))

    def jfn(A, y, na):
        return jnp.sum(jim.mll_via_inverse(A, y, na) * jnp.arange(1.0, b + 1))

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(A), jnp.asarray(y), jnp.asarray(n_active))
    tA, ty, tn = (T(a).requires_grad_(True) for a in (A, y, n_active))
    tv = torch.sum(tim.mll_via_inverse(tA, ty, tn, route_blocked=True)
                   * torch.arange(1.0, b + 1, dtype=F64))
    tg = torch.autograd.grad(tv, (tA, ty, tn))
    assert counted == [(b, n, n)]
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    for a, g in zip(tg, jg):
        close(a, g, rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def gp_inputs():
    rng = np.random.default_rng(7)
    n, d = 192, 3
    X = rng.uniform(size=(n, d))
    y = rng.normal(size=(n,))
    return X, y


def test_gp_mll_blocked_route_value(gp_inputs, monkeypatch, counted):
    X, y = gp_inputs
    monkeypatch.setattr(pbc, "_ROUTE_BLOCKED", True)
    jcfg = jgp.source_gp_config()
    jp = jgp.init_params(jcfg, X.shape[1], jnp.float64)
    jv = jgp.mll(jcfg, jp, jnp.asarray(X), jnp.asarray(y), method="sweep")
    tcfg = tgp.source_gp_config()
    tp = tgp.init_params(tcfg, X.shape[1], F64, "cpu")
    tv = tgp.mll(tcfg, tp, T(X), T(y), method="sweep", route_blocked=True)
    assert counted == [(1, 192, 192)]
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-10)


def test_gp_mll_blocked_route_gradient(gp_inputs, counted):
    """Against the ``"chol"`` gradients of the port and of the JAX package:
    JAX ``gp.mll(method="sweep")`` gradients raise (ROADMAP queue 3)."""
    X, y = gp_inputs
    d = X.shape[1]
    jcfg = jgp.source_gp_config()
    jp = jgp.init_params(jcfg, d, jnp.float64)
    jp = jp._replace(raw_lengthscale=jp.raw_lengthscale + jnp.arange(d) / 4)
    jg = jax.grad(lambda p: jgp.map_objective(
        jcfg, p, jnp.asarray(X), jnp.asarray(y), method="chol"))(jp)
    tcfg = tgp.source_gp_config()
    grads = {}
    for method, route in (("sweep", True), ("chol", False)):
        tp = convert.gp_params(convert.to_numpy_dict(jp), device="cpu")
        tp = tgp.GPParams(*[leaf.requires_grad_(True) for leaf in tp])
        v = tgp.map_objective(tcfg, tp, T(X), T(y), method=method,
                              route_blocked=route)
        grads[method] = torch.autograd.grad(v, tuple(tp))
    assert counted == [(1, 192, 192)]
    for a, b, c in zip(grads["sweep"], grads["chol"], jg):
        close(a, b.numpy(), rtol=1e-7, atol=1e-9)
        close(a, c, rtol=1e-7, atol=1e-9)


def test_meta_fit_blocked_route_matches_jax_chol(counted):
    """2 tasks x (warm + 2 prior draws) x 10 L-BFGS steps at N_m = 192, from
    the JAX draws; the JAX sweep route cannot run here (ROADMAP queue 3), so
    the JAX side fits with ``"chol"``."""
    rng = np.random.default_rng(11)
    n, d, restarts, steps = 192, 2, 2, 10
    xs = [rng.uniform(size=(n, d)) for _ in range(2)]
    ys = [np.sin(3 * x[:, 0]) * (i + 1) + x[:, 1] + 0.1 * rng.normal(size=n)
          for i, x in enumerate(xs)]
    jcfg = jgp.source_gp_config()
    jdata = jm.pack_task_data(xs, ys, dtype=jnp.float64)
    key = jax.random.PRNGKey(4)
    jstack = jm.meta_fit_task_stack(jdata, jcfg, key, num_restarts=restarts,
                                    num_steps=steps, mll_method="chol")
    warm = jgp.init_params(jcfg, d, jnp.float64)

    def task_init(task_key):
        keys = jax.random.split(task_key, restarts)
        sampled = jax.vmap(lambda k: jgp.sample_params(jcfg, k, d,
                                                       jnp.float64))(keys)
        return jfit.stack_restarts(warm, sampled)

    init = jax.vmap(task_init)(jax.random.split(key, len(xs)))
    tstack = tm.meta_fit_task_stack(
        tm.pack_task_data(xs, ys, dtype=F64, device="cpu"),
        tgp.source_gp_config(), num_steps=steps, mll_method="sweep",
        init_stack=convert.gp_params(convert.to_numpy_dict(init),
                                     device="cpu"),
        route_blocked=True)
    assert counted and set(counted) == {(2 * (restarts + 1), n, n)}
    for a, b in zip(tstack.params, jstack.params):
        close(a, b, rtol=1e-6, atol=1e-8)
    close(tstack.alpha, jstack.alpha, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [128, 192, 256, 512, 1024, 2048])
def test_blocked_routing_matches_jax(n, itemsize, route, monkeypatch):
    monkeypatch.setattr(pbc, "_ROUTE_BLOCKED", route)
    assert tbc.blocked_runnable(n, itemsize) == pbc.blocked_runnable(
        n, itemsize)
    assert tbc.blocked_profitable(n, itemsize, route) == \
        pbc.blocked_profitable(n, itemsize)
    assert tim.inverse_mll_profitable(n, itemsize, route) == \
        jim.inverse_mll_profitable(n, itemsize)


def test_blocked_variant_choice():
    """By bytes: the lower blocks and eight vectors in one CTA's shared
    memory (at most 227 KiB), else the device-memory variant.  Forcing
    ``smem`` where it cannot run raises, on the CPU too."""
    assert tbc.choose_variant(256, 4) == "smem"      # 162 KiB
    assert tbc.choose_variant(192, 8) == "smem"      # 196 KiB
    assert tbc.choose_variant(320, 4) == "global"    # 242 KiB
    assert tbc.choose_variant(256, 8) == "global"
    assert tbc.choose_variant(512, 4) == "global"
    assert tbc.choose_variant(88, 4, "global") == "global"
    for n, dtype in ((512, torch.float32), (256, F64)):
        with pytest.raises(ValueError, match="shared memory"):
            tbc.blocked_chol_inverse(torch.eye(n, dtype=dtype)[None], "smem")
    with pytest.raises(ValueError, match="unknown variant"):
        tbc.blocked_chol_inverse(torch.eye(4)[None], "vmem")


def test_route_blocked_is_off_by_default():
    assert not tc.CampaignConfig().route_blocked
    assert not tim.inverse_mll_profitable(256, 4)
    assert tim.inverse_mll_profitable(256, 4, route_blocked=True)


def test_hartmann_units_match():
    rng = np.random.default_rng(5)
    S = 7
    alphas = {f"alpha{i}": rng.uniform(0.9, 3.5, size=S) for i in range(1, 5)}
    jtp = {k: jnp.asarray(v) for k, v in alphas.items()}
    ttp = {k: T(v) for k, v in alphas.items()}
    for d, jfn, tfn in ((3, ja.hartmann3_unit, ta.hartmann3_unit),
                        (6, ja.hartmann6_unit, ta.hartmann6_unit)):
        x = rng.uniform(size=(S, d))
        close(tfn(T(x), ttp), jax.vmap(jfn)(jnp.asarray(x), jtp),
              rtol=1e-12)


def test_hartmann6_campaign_inputs_match():
    """Seeded meta-data agree exactly.  The target task is unseeded by
    design, so the optima are compared on the port's own tasks: the port's
    ``device_optima`` against the JAX package's."""
    args = (THartmann6D, [16] * 2, range(2))
    j = ja.campaign_inputs_from_benchmark(JHartmann6D, *args[1:],
                                          noise_std=0.1, dtype=jnp.float64,
                                          optimum_method="device")
    t = ta.campaign_inputs_from_benchmark(*args, noise_std=0.1, dtype=F64,
                                          device="cpu",
                                          optimum_method="device")
    assert t[2].X.shape == (2, 2, 16, 6)
    for a, b in zip(t[2], j[2]):
        close(a, b, rtol=1e-12, atol=1e-14)
    tfn, ttp, _, topt = t
    jopt = ja.device_optima(
        ja.hartmann6_unit, {k: jnp.asarray(v.numpy()) for k, v in
                            ttp.items()}, 6)
    close(topt, jopt, rtol=1e-5)
    x = torch.rand((2, 4096, 6), generator=torch.Generator().manual_seed(1),
                   dtype=F64)
    vals = tfn(x, {k: v[:, None] for k, v in ttp.items()})
    assert (topt <= vals.min(-1).values).all()


@pytest.fixture(scope="module")
def blocked_iteration():
    """Everything an iteration consumes at N_m = 192 (two studies of two
    tasks, two points seen), made on the JAX side, and the JAX iteration
    with the ``"chol"`` route."""
    S, M, n, E = 2, 2, 192, 4
    rng = np.random.default_rng(13)
    xs = rng.uniform(size=(S, M, n, 2))
    ys = np.sin(3 * xs[..., 0]) + xs[..., 1] + 0.1 * rng.normal(size=(S, M, n))
    datas = [jm.pack_task_data(list(xs[s]), list(ys[s]), dtype=jnp.float64)
             for s in range(S)]
    jmd = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *datas)
    flat = jm.TaskData(*[l.reshape((S * M,) + l.shape[2:]) for l in jmd])
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()
    fs = jm.meta_fit_task_stack(flat, scfg, jax.random.PRNGKey(1),
                                num_restarts=1, num_steps=5)
    jstack = jax.tree_util.tree_map(
        lambda l: l.reshape((S, M) + l.shape[1:]), fs)
    Xbuf = np.zeros((S, E, 2))
    Xbuf[:, :2] = rng.uniform(size=(S, 2, 2))
    mask = (np.arange(E) < 2) * np.ones((S, E))
    ybuf = rng.normal(size=(S, E)) * mask
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
    ref = jax.jit(_jax_iteration)(jstack, warm, *(jnp.asarray(a) for a in
                                                  (Xbuf, ybuf, mask)),
                                  keys, raw)
    return dict(jstack=jstack, bufs=(Xbuf, ybuf, mask), restarts=restarts,
                raw=raw, warm=warm, ref=ref)


def test_one_lock_step_iteration_matches_on_the_blocked_route(
        blocked_iteration):
    """The pattern of ``test_one_lock_step_iteration_matches`` with an
    N_m = 192 source stack and ``route_blocked=True``.  The target fit's
    systems are E x E, so the sweep serves them; the blocked kernel's share
    of a campaign is the meta-fit (``test_meta_fit_blocked_route_...``)."""
    it, ref = blocked_iteration, blocked_iteration["ref"]
    scfg_t, tcfg_t = tgp.source_gp_config(), tgp.target_gp_config()
    cfg_t = tc.CampaignConfig(mll_method="sweep", route_blocked=True, **CFG)
    tstack = convert.source_stack(convert.to_numpy_dict(it["jstack"]),
                                  device="cpu")
    tX, ty, tmk = (T(a) for a in it["bufs"])
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
    close(tfit.flatten(tparams, 1), tfit.flatten(jparams, 1), rtol=1e-6,
          atol=1e-9)
    tstate = tc._study_acq_state(tstack, scfg_t, tcfg_t, tparams, tX, ty, tmk,
                                 om_t, os_t, cfg_t.pruning_threshold)
    tx = tc._propose(tstack, scfg_t, tcfg_t, tstate, tX, T(it["raw"]), cfg_t)
    close(tx, ref["x"], rtol=1e-6, atol=1e-9)


def test_tiny_campaign_blocked_route_matches_chol(counted):
    """S=2, M=2, N_m=192, E=2 in float64: the blocked route and the chol
    route propose the same points, and the CPU launches no kernel."""
    rng = np.random.default_rng(17)
    S, M, n = 2, 2, 192
    xs = rng.uniform(size=(S, M, n, 2))
    ys = np.cos(4 * xs[..., 0]) + xs[..., 1] ** 2 + 0.1 * rng.normal(
        size=(S, M, n))
    datas = [tm.pack_task_data(list(xs[s]), list(ys[s]), dtype=F64,
                               device="cpu") for s in range(S)]
    md = tm.TaskData(*[torch.stack(ls) for ls in zip(*datas)])
    tp = {k: T(rng.uniform(lo, hi, size=S)) for k, lo, hi in
          (("a", 0.5, 1.5), ("b", 0.1, 0.15), ("c", 1.0, 2.0),
           ("r", 5.0, 7.0), ("s", 8.0, 12.0), ("t", 0.03, 0.05))}
    cfg = tc.CampaignConfig(n_evaluations=2, mll_method="sweep", **CFG)
    out = {}
    for route in (False, True):
        out[route] = tc.run_campaign(
            ta.branin_unit, tp, md, seed=0,
            cfg=dataclasses.replace(cfg, route_blocked=route),
            meta_fit_restarts=1, meta_fit_steps=6, device="cpu")
    assert counted and set(counted) == {(S * M * 2, n, n)}
    assert all(c == [0, 0, 0] for c in out[True].launches.values())
    close(out[True].X, out[False].X.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("nb,now,first", [(1, 4, 6), (2, 21, 28)])
def test_global_tile_transfers_counted_by_hand(nb, now, first):
    """The ``global`` kernel's device tile traffic at sizes counted by hand:
    at nb = 2 the Cholesky reads and writes L00, the panel L10 and L11 at
    step 0 and L11 at step 1 (8), W10 takes L10, L00 and L11 in and W10
    out (4), W^T W reads 2 + 2 + 1 tiles and writes 1 + 2 + 1 (9); the
    first version added a padded copy of the three lower blocks (6) and a
    second read of L10 at step 0 (1)."""
    from scamlgp_tpu_torch.profile_kernels import global_tile_transfers
    assert global_tile_transfers(nb) == now
    assert global_tile_transfers(nb, first=True) == first
