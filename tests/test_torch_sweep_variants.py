"""Port parity: the sweep's three further step schemes (fused, pair,
blocked), their analytic-gradient wrappers, and the slice that runs them.

On the CPU, where the port's wrapper runs the plain version of each scheme:

- each scheme's plain version against its own TPU kernel body
  (``_sweep_kernel_fused``, ``_sweep_kernel_pair``,
  ``_sweep_kernel_blocked``) run through ``pl.pallas_call(...,
  interpret=True)`` in the input's dtype, and against numpy: float32 to
  atol 5e-5 of the kernel (as ``tests/test_sweep.py`` holds the kernels
  against numpy), float64 to rtol 1e-10;
- ``SweepInverse``'s gradient and ``mll_via_sweep`` against the JAX
  ``sweep_inverse`` / ``mll_via_sweep`` and their VJP, float64, rtol 1e-9;
- the dispatch rule: a scheme that the shape does not allow runs
  ``select``, as the reference's dispatch falls through;
- the slice as a whole, per ``sweep_variant``: Hartmann6D inputs from both
  packages' adapters (M = 2, N_m = 32, float64) and the same draws; the
  port's meta-fit against the JAX meta-fit with ``mll_method="sweep"``, and
  one lock-step iteration against the JAX ``_fit_target`` and
  ``_study_acq_state`` with ``mll_method="sweep"``, 12 L-BFGS steps, rtol
  1e-6 (longer fits amplify roundoff, ROADMAP queue 3).  The JAX sweep
  route's gradient fails on a scalar ``n_active`` (the reference fault of
  ROADMAP queue 3); the ``jax_sweep_route`` fixture hands the reference's
  own ``mll_via_inverse`` a batch-shaped one, as
  ``tests/test_torch_sweep.py`` does;
- the kernel N-scaling bench at tiny shapes, and the campaign's stage
  timer.

The CUDA kernels are held against the plain versions in
``tests/test_torch_cuda.py``, on the card.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import scamlgp_tpu.ops.pallas_sweep as ps
from scamlgp_tpu.benchmarking import jax_adapters as ja
from scamlgp_tpu.benchmarking.benchmarks import Hartmann6D as JHartmann6D
from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.ops import inverse_mll as jim
from scamlgp_tpu_torch import bench_sweep_n, convert
from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    Hartmann6D as THartmann6D,
)
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.ops import sweep as tsw
from scamlgp_tpu_torch.parallel import campaign as tc
from scamlgp_tpu_torch.utils import profiling
from tests.test_torch_campaign import CFG, _jax_iteration

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = {"fused": ps._sweep_kernel_fused, "pair": ps._sweep_kernel_pair,
          "blocked": ps._sweep_kernel_blocked}


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


def _spd_batch(rng, b, n, dtype, jitter=0.5):
    X = rng.normal(size=(b, n, n))
    return (np.einsum("bij,bkj->bik", X, X) / n
            + jitter * np.eye(n)).astype(dtype)


def _run_pallas(kernel, A):
    """The TPU kernel body over the whole batch in one program, in A's
    dtype (``tests/test_sweep.py:21-37``)."""
    b, n, _ = A.shape
    dt = jnp.dtype(A.dtype)
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((b, n, n), dt),
                   jax.ShapeDtypeStruct((b, 1), dt)),
        grid_spec=pl.GridSpec(
            grid=(1,),
            in_specs=[pl.BlockSpec((b, n, n), lambda i: (0, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=(pl.BlockSpec((b, n, n), lambda i: (0, 0, 0),
                                    memory_space=pltpu.VMEM),
                       pl.BlockSpec((b, 1), lambda i: (0, 0),
                                    memory_space=pltpu.VMEM)),
        ),
        interpret=True,
    )(jnp.asarray(A))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant,n,b", [
    ("fused", 9, 3), ("fused", 32, 2), ("pair", 8, 4), ("pair", 32, 2),
    ("blocked", 32, 3), ("blocked", 64, 2)])
def test_plain_variant_matches_its_pallas_kernel(variant, n, b, dtype):
    A = _spd_batch(np.random.default_rng(n + b), b, n, dtype)
    inv_j, ld_j = _run_pallas(PALLAS[variant], A)
    inv_t, ld_t = tsw.sweep_inverse(torch.as_tensor(A), variant)   # plain
    assert inv_t.dtype == torch.as_tensor(A).dtype
    inv_np = np.linalg.inv(A.astype(np.float64))
    ld_np = np.linalg.slogdet(A.astype(np.float64))[1]
    if dtype == np.float32:
        np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j),
                                   atol=5e-5)
        np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j[:, 0]),
                                   atol=5e-5)
        np.testing.assert_allclose(inv_t.numpy(), inv_np, atol=5e-5)
        np.testing.assert_allclose(ld_t.numpy(), ld_np, atol=5e-5)
    else:
        for ref in (np.asarray(inv_j), inv_np):
            np.testing.assert_allclose(inv_t.numpy(), ref, rtol=1e-10,
                                       atol=1e-12)
        for ref in (np.asarray(ld_j[:, 0]), ld_np):
            np.testing.assert_allclose(ld_t.numpy(), ref, rtol=1e-10)


@pytest.mark.parametrize("variant,n", [("blocked", 40), ("pair", 9),
                                       ("blocked", 8)])
def test_a_scheme_the_shape_refuses_runs_select(variant, n):
    """``pallas_sweep.py:428-436``: blocked only where N % 32 == 0, pair
    only where N is even."""
    assert tsw.resolve_variant(n, variant) == "select"
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 2, n,
                                   np.float64))
    for a, b in zip(tsw.sweep_inverse(A, variant),
                    tsw.sweep_inverse_reference(A, "select")):
        assert torch.equal(a, b)


def test_every_scheme_is_resolved_as_the_reference_dispatches():
    assert [tsw.resolve_variant(n, v) for v in tsw.VARIANTS
            for n in (31, 32, 64, 65)] == [
        "select"] * 4 + ["fused"] * 4 + ["select", "pair", "pair", "select"] + [
        "select", "blocked", "blocked", "select"]
    with pytest.raises(ValueError, match="unknown sweep variant"):
        tsw.sweep_inverse(torch.eye(4, dtype=F64)[None], "rank2")


@pytest.mark.parametrize("variant", tsw.VARIANTS)
def test_sweep_inverse_vjp_and_mll_via_sweep_match_jax(variant):
    """The JAX ``sweep_inverse`` on the CPU is its Cholesky fallback with
    the same custom VJP; the port's runs the scheme's plain version."""
    rng = np.random.default_rng(21)
    b, n = 3, 32
    A = _spd_batch(rng, b, n, np.float64)
    y = rng.normal(size=(b, n))
    G = rng.normal(size=(b, n, n))
    w = rng.normal(size=(b,))

    def jfn(A):
        Ainv, ld = ps.sweep_inverse(A)
        return jnp.sum(Ainv * G) + jnp.sum(ld * w)

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(A))
    tA = T(A).requires_grad_(True)
    Ainv, ld = tsw.SweepInverse.apply(tA, variant)
    tv = torch.sum(Ainv * T(G)) + torch.sum(ld * T(w))
    tg, = torch.autograd.grad(tv, tA)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    close(tg, jg, rtol=1e-9, atol=1e-11)

    jv, jg = jax.value_and_grad(
        lambda A: jnp.sum(ps.mll_via_sweep(A, jnp.asarray(y)) * w))(
            jnp.asarray(A))
    tA = T(A).requires_grad_(True)
    tv = torch.sum(tsw.mll_via_sweep(tA, T(y), variant=variant) * T(w))
    tg, = torch.autograd.grad(tv, tA)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    close(tg, jg, rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# The slice as a whole: Hartmann6D, M = 2, N_m = 32, float64
# ---------------------------------------------------------------------------

S, M, NPTS, E, RESTARTS, STEPS = 2, 2, 32, 4, 2, 12


@pytest.fixture(scope="module")
def jax_sweep_route():
    """The JAX ``mll_method="sweep"`` route with the reference's own
    ``mll_via_inverse`` given a batch-shaped ``n_active`` (its VJP returns
    the scalar's cotangent with shape (1,), ROADMAP queue 3)."""
    orig = jim.mll_via_inverse
    jim.mll_via_inverse = lambda A, y, n: orig(
        A, y, jnp.broadcast_to(n, A.shape[:-2]))
    yield
    jim.mll_via_inverse = orig


@pytest.fixture(scope="module")
def hm6(jax_sweep_route):
    """Both packages' Hartmann6D inputs, the JAX sweep-route meta-fit with
    its draws, and one JAX sweep-route iteration at i = 2."""
    kw = dict(noise_std=0.1, optimum_method="device")
    jfn, jtp, jmd, _ = ja.campaign_inputs_from_benchmark(
        JHartmann6D, [NPTS] * M, range(S), dtype=jnp.float64, **kw)
    tmd = ta.campaign_inputs_from_benchmark(
        THartmann6D, [NPTS] * M, range(S), dtype=F64, device="cpu", **kw)[2]
    for a, b in zip(tmd, jmd):
        close(a, b, rtol=1e-12, atol=1e-14)
    scfg, tcfg = jgp.source_gp_config(), jgp.target_gp_config()
    d = 6
    flat = jm.TaskData(*[l.reshape((S * M,) + l.shape[2:]) for l in jmd])
    key = jax.random.PRNGKey(3)
    fs = jm.meta_fit_task_stack(flat, scfg, key, num_restarts=RESTARTS,
                                num_steps=STEPS, mll_method="sweep")
    warm = jgp.init_params(scfg, d, jnp.float64)

    def task_init(task_key):
        keys = jax.random.split(task_key, RESTARTS)
        sampled = jax.vmap(lambda k: jgp.sample_params(scfg, k, d,
                                                       jnp.float64))(keys)
        return jfit.stack_restarts(warm, sampled)

    init = jax.vmap(task_init)(jax.random.split(key, S * M))
    jstack = jax.tree_util.tree_map(
        lambda l: l.reshape((S, M) + l.shape[1:]), fs)

    rng = np.random.default_rng(8)
    Xbuf = np.zeros((S, E, d))
    Xbuf[:, :2] = rng.uniform(size=(S, 2, d))
    yclean = np.asarray(jax.vmap(jax.vmap(jfn, (0, None)))(
        jnp.asarray(Xbuf), jtp))
    mask = (np.arange(E) < 2) * np.ones((S, E))
    ybuf = (yclean + 0.1 * rng.normal(size=(S, E))) * mask
    keys = jax.random.split(jax.random.PRNGKey(5), S)
    restarts = jax.vmap(lambda k: jax.vmap(lambda kk: jm.sample_target_params(
        tcfg, kk, M, d, jnp.float64))(jax.random.split(k, 5)))(keys)
    raw = jax.random.uniform(jax.random.PRNGKey(6),
                             (S, CFG["acq_raw_samples"], d), jnp.float64)
    wparams = jm.TargetParams(
        raw_weights=jm.weights_inverse(jnp.full((S, M), 1.0 / M)),
        gp=jax.vmap(lambda _: jgp.init_params(tcfg, d, jnp.float64))(
            jnp.arange(S)))
    ref = jax.jit(functools.partial(_jax_iteration, mll_method="sweep"))(
        jstack, wparams, *(jnp.asarray(a) for a in (Xbuf, ybuf, mask)),
        keys, raw)
    return dict(tmd=tmd, fs=fs, init=init, jstack=jstack,
                bufs=(Xbuf, ybuf, mask), restarts=restarts, raw=raw,
                warm=wparams, ref=ref)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts, per scheme, the calls of the plain versions (the CPU's
    route)."""
    calls = {v: 0 for v in tsw.VARIANTS}
    for v, fn in list(tsw._PLAIN.items()):
        def spy(A, logdet, fn=fn, v=v):
            calls[v] += 1
            return fn(A, logdet)
        monkeypatch.setitem(tsw._PLAIN, v, spy)
    return calls


@pytest.mark.parametrize("variant", tsw.VARIANTS)
def test_meta_fit_matches_jax_sweep_route(hm6, variant, plain_calls):
    tflat = tm.TaskData(*[l.reshape((S * M,) + l.shape[2:])
                          for l in hm6["tmd"]])
    tstack = tm.meta_fit_task_stack(
        tflat, tgp.source_gp_config(), num_steps=STEPS, mll_method="sweep",
        init_stack=convert.gp_params(convert.to_numpy_dict(hm6["init"]),
                                     device="cpu"),
        sweep_variant=variant)
    assert plain_calls[variant] > 0
    assert sum(plain_calls.values()) == plain_calls[variant]
    for a, b in zip(tstack.params, hm6["fs"].params):
        close(a, b, rtol=1e-6, atol=1e-8)
    close(tstack.alpha, hm6["fs"].alpha, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("variant", tsw.VARIANTS)
def test_one_lock_step_iteration_matches_jax_sweep_route(hm6, variant,
                                                         plain_calls):
    """The target systems are E x E = 4 x 4: fused and pair take them,
    blocked falls through to select."""
    ref = hm6["ref"]
    scfg_t, tcfg_t = tgp.source_gp_config(), tgp.target_gp_config()
    cfg_t = tc.CampaignConfig(mll_method="sweep", sweep_variant=variant,
                              **CFG)
    tstack = convert.source_stack(convert.to_numpy_dict(hm6["jstack"]),
                                  device="cpu")
    tX, ty, tmk = (T(a) for a in hm6["bufs"])
    om_t, os_t = tm.output_normalizer(tstack, ty, tmk)
    restarts = convert.target_params(convert.to_numpy_dict(hm6["restarts"]),
                                     device="cpu")
    warm = convert.target_params(convert.to_numpy_dict(hm6["warm"]),
                                 device="cpu")
    tparams = tc._fit_target(tstack, scfg_t, tcfg_t, warm, tX, ty, tmk, om_t,
                             os_t, restarts, cfg_t)
    assert plain_calls[tsw.resolve_variant(E, variant)] > 0
    jparams = convert.target_params(convert.to_numpy_dict(ref["params"]),
                                    device="cpu")
    close(tfit.flatten(tparams, 1), tfit.flatten(jparams, 1), rtol=1e-6,
          atol=1e-9)
    tstate = tc._study_acq_state(tstack, scfg_t, tcfg_t, tparams, tX, ty, tmk,
                                 om_t, os_t, cfg_t.pruning_threshold)
    tmu, tvar = tc._study_posterior_diag_fast(tstack, scfg_t, tcfg_t, tstate,
                                              tX, T(hm6["raw"]))
    ucb = -tmu + 3.0 * torch.sqrt(torch.clamp_min(tvar, 1e-30))
    close(ucb, ref["ucb"], rtol=1e-6, atol=1e-9)
    tx = tc._propose(tstack, scfg_t, tcfg_t, tstate, tX, T(hm6["raw"]),
                     cfg_t)
    close(tx, ref["x"], rtol=1e-6, atol=1e-9)


def test_campaign_records_its_stages_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(4)
    xs = rng.uniform(size=(1, M, 8, 6))
    datas = [tm.pack_task_data(list(xs[0]), list(np.sin(xs[0].sum(-1))),
                               dtype=F64, device="cpu")]
    md = tm.TaskData(*[torch.stack(ls) for ls in zip(*datas)])
    tp = {f"alpha{i}": T(rng.uniform(0.9, 3.5, size=1)) for i in range(1, 5)}
    cfg = tc.CampaignConfig(n_evaluations=2, mll_method="sweep",
                            sweep_variant="fused", **CFG)
    profiling.GLOBAL_TIMER.reset()
    res = tc.run_campaign(ta.hartmann6_unit, tp, md, seed=0, cfg=cfg,
                          meta_fit_restarts=1, meta_fit_steps=3,
                          device="cpu")
    report = profiling.GLOBAL_TIMER.report()
    assert {k: v["count"] for k, v in report.items()} == {
        "campaign_stage_inputs": 1, "campaign_meta_fit": 1,
        "campaign_bo_loop": 1, "campaign_iteration": 2,
        "iteration_draws": 2, "iteration_fit_target": 2,
        "iteration_acq_state": 2, "iteration_propose": 2,
        "iteration_benchmark": 2}
    assert report["campaign_bo_loop"]["total_s"] >= \
        report["campaign_iteration"]["total_s"] > 0
    assert all(c == [0, 0, 0] for c in res.launches.values())
    assert res.nonfinite_source_tasks == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_bench_sweep_n_on_the_cpu():
    """Every variant at tiny shapes: a number where the variant takes the
    shape, ``FAILED`` where it does not (blocked at N = 40)."""
    out = bench_sweep_n.run([(2, 32), (2, 40)], list(bench_sweep_n.VARIANTS),
                            device="cpu", rounds=1)
    assert out["card"] == "cpu"
    row32, row40 = out["results"]
    for v in bench_sweep_n.VARIANTS:
        assert isinstance(row32[v], float) and row32[v] > 0
    assert row40["blocked"].startswith("FAILED: ValueError")
    assert all(isinstance(row40[v], float) for v in bench_sweep_n.VARIANTS
               if v != "blocked")
    # the CPU runs plain versions: no kernel launches anywhere
    assert all(not n for row in out["results"]
               for n in row["launches"].values())


def test_no_environment_variable_selects_a_scheme():
    """The reference reads ``SCAMLGP_SWEEP_STEP`` at import; the port takes
    the scheme as an argument only."""
    code = ("from scamlgp_tpu_torch.parallel.campaign import CampaignConfig;"
            "import inspect;"
            "from scamlgp_tpu_torch.ops import sweep, inverse_mll;"
            "print(CampaignConfig().sweep_variant,"
            " inspect.signature(sweep.sweep_inverse)"
            ".parameters['variant'].default,"
            " inspect.signature(inverse_mll.mll_via_inverse)"
            ".parameters['sweep_variant'].default)")
    env = dict(os.environ, SCAMLGP_SWEEP_STEP="fused", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["select"] * 3
