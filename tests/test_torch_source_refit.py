"""A source GP whose float32 factor fails after an inverse-route meta-fit.

``DEGENERATE`` holds the raw hyperparameters that the sweep-route meta-fit
of the Branin T8 N_m=32 campaign (32 studies, seed 0, float32) reached for
study 28, task 2 on an NVIDIA H100: lengthscales (0.240, 5.80),
outputscale 8.00, noise 4.05e-8.  There the sweep's float32 MLL was finite
while the float32 system is not positive definite, so its Cholesky fails.
These tests hold, on the CPU in float32 and on that study's own data:

- from the campaign's own restarts, neither package's sweep-route
  meta-fit of the study leaves a non-finite factor on the CPU (the JAX
  package's sweep route runs its Cholesky inverse there);
- both packages' ``finalize_source_stack`` leave task 2's factor NaN at
  ``DEGENERATE``, and the NaN reaches its study's target objective with
  no target data;
- the port's ``refit_nonfinite_tasks`` fits that task again on the
  Cholesky route from the same restarts, leaves every other task as it
  was, and the study's predictions and target objective come out finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.benchmarking import jax_adapters as ja
from scamlgp_tpu.benchmarking.benchmarks import Branin as JBranin
from scamlgp_tpu.models import fit as jfit
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.ops import inverse_mll as jim
from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin as TBranin
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER

F32 = torch.float32
M, NPTS, STUDY, TASK, RESTARTS, STEPS = 8, 32, 28, 2, 3, 12
STUDIES, META_STEPS = 32, 50        # the campaign's studies and meta-fit
DEGENERATE = ([-6.028625011444092, -2.788215398788452], -2.441878318786621,
              -12.699590682983398)


def finite_tasks(chol, alpha):
    chol, alpha = np.asarray(chol), np.asarray(alpha)
    return (np.isfinite(chol.reshape(chol.shape[0], -1)).all(-1)
            & np.isfinite(alpha).all(-1))


@pytest.fixture(scope="module")
def study():
    """Study 28's meta-data in both packages, warm-start hyperparameters
    with task 2's replaced by DEGENERATE, and the study's restarts, drawn
    as ``run_campaign`` draws them for the whole campaign."""
    kw = dict(noise_std=1.0, optimum_method="device")
    tmd = ta.campaign_inputs_from_benchmark(
        TBranin, [NPTS] * M, [STUDY], dtype=F32, device="cpu", **kw)[2]
    jmd = ja.campaign_inputs_from_benchmark(
        JBranin, [NPTS] * M, [STUDY], dtype=jnp.float32, **kw)[2]
    tdata = tm.TaskData(*[leaf[0] for leaf in tmd])
    jdata = jm.TaskData(*[leaf[0] for leaf in jmd])
    cfg = tgp.source_gp_config()
    params = tgp.init_params(cfg, 2, F32, "cpu", batch_shape=(M,))
    for leaf, value in zip(params, DEGENERATE):
        leaf[TASK] = torch.tensor(value, dtype=F32)
    gen = torch.Generator().manual_seed(0)
    drawn = tgp.sample_params(cfg, gen, 2, F32,
                              batch_shape=(STUDIES * M, RESTARTS))
    init = tfit.stack_restarts(
        tgp.init_params(cfg, 2, F32, "cpu", batch_shape=(M,)),
        tfit.tree_map(lambda leaf: leaf[STUDY * M:(STUDY + 1) * M], drawn),
        1)
    return dict(tdata=tdata, jdata=jdata, params=params, init=init)


def target_objective(stack, cfg):
    """The study's target MAP objective at the warm start with no target
    data (its first iteration), as the campaign builds it."""
    tcfg = tgp.target_gp_config()
    Xbuf = torch.zeros((4, 2), dtype=F32)
    zeros = torch.zeros(4, dtype=F32)
    means, covs = tm.source_predict(stack, cfg, Xbuf, full_cov=True)
    w = torch.full((M,), 1.0 / M, dtype=F32)
    return tgp.map_objective(
        tcfg, tgp.init_params(tcfg, 2, F32, "cpu"), Xbuf, zeros, mask=zeros,
        prior_mean=torch.einsum("mq,m->q", means, w),
        prior_cov=torch.einsum("mqp,m->qp", covs, w ** 2))


def test_meta_fit_of_the_study_is_finite_on_the_cpu(study, monkeypatch):
    cfg = tgp.source_gp_config()
    tstack = tm.meta_fit_task_stack(study["tdata"], cfg,
                                    num_steps=META_STEPS, mll_method="sweep",
                                    init_stack=study["init"])
    assert finite_tasks(tstack.chol, tstack.alpha).all()

    # the reference's VJP needs a batch-shaped n_active (ROADMAP queue 3)
    orig = jim.mll_via_inverse
    monkeypatch.setattr(jim, "mll_via_inverse", lambda A, y, n: orig(
        A, y, jnp.broadcast_to(n, A.shape[:-2])))
    jcfg, jdata = jgp.source_gp_config(), study["jdata"]

    def fit_one(x, y, mask, stack0):
        return jfit.fit_map_restarts(
            lambda p: jgp.map_objective(jcfg, p, x, y, mask, method="sweep"),
            stack0, num_steps=META_STEPS).params

    jinit = jgp.GPParams(*[jnp.asarray(leaf.numpy())
                           for leaf in study["init"]])
    params = jax.jit(jax.vmap(fit_one))(jdata.X, jdata.y, jdata.mask, jinit)
    jstack = jm.finalize_source_stack(jdata, jcfg, params)
    assert finite_tasks(jstack.chol, jstack.alpha).all()


def test_both_packages_keep_the_nan_factor(study):
    cfg = tgp.source_gp_config()
    tstack = tm.finalize_source_stack(study["tdata"], cfg, study["params"])
    expect = np.arange(M) != TASK
    np.testing.assert_array_equal(finite_tasks(tstack.chol, tstack.alpha),
                                  expect)
    assert not torch.isfinite(target_objective(tstack, cfg))

    jparams = jgp.GPParams(*[jnp.asarray(leaf.numpy())
                             for leaf in study["params"]])
    jstack = jm.finalize_source_stack(study["jdata"], jgp.source_gp_config(),
                                      jparams)
    np.testing.assert_array_equal(finite_tasks(jstack.chol, jstack.alpha),
                                  expect)
    _, jcovs = jm.source_predict(jstack, jgp.source_gp_config(),
                                 jnp.zeros((4, 2), jnp.float32))
    assert not bool(jnp.isfinite(jcovs[TASK]).any())


def test_refit_replaces_only_the_nonfinite_task(study):
    cfg = tgp.source_gp_config()
    stack = tm.finalize_source_stack(study["tdata"], cfg, study["params"])
    GLOBAL_TIMER.reset()
    fixed = tm.refit_nonfinite_tasks(stack, cfg, study["init"], STEPS)
    assert GLOBAL_TIMER.report()["meta_fit_refit_chol"]["count"] == 1
    assert finite_tasks(fixed.chol, fixed.alpha).all()
    keep = torch.arange(M) != TASK
    for a, b in zip((*fixed.params, fixed.chol, fixed.alpha),
                    (*stack.params, stack.chol, stack.alpha)):
        assert torch.equal(a[keep], b[keep])
    # task 2 is the Cholesky-route fit from its own restarts
    one = torch.arange(M) == TASK
    alone = tm.meta_fit_task_stack(
        tm.TaskData(*[leaf[one] for leaf in study["tdata"]]), cfg,
        num_steps=STEPS, mll_method="chol",
        init_stack=tfit.tree_map(lambda leaf: leaf[one], study["init"]))
    for a, b in zip((*fixed.params, fixed.chol, fixed.alpha),
                    (*alone.params, alone.chol, alone.alpha)):
        assert torch.equal(a[one], b)
    means, covs = tm.source_predict(fixed, cfg, study["tdata"].X[0, :5])
    assert torch.isfinite(means).all() and torch.isfinite(covs).all()
    assert torch.isfinite(target_objective(fixed, cfg))


def test_refit_leaves_a_finite_stack_alone(study):
    cfg = tgp.source_gp_config()
    params = tgp.init_params(cfg, 2, F32, "cpu", batch_shape=(M,))
    stack = tm.finalize_source_stack(study["tdata"], cfg, params)
    assert tm.refit_nonfinite_tasks(stack, cfg, study["init"], STEPS) is stack


@pytest.mark.parametrize("mll_method", ["sweep", "chol"])
def test_meta_fit_refits_on_the_inverse_route_only(study, mll_method,
                                                   monkeypatch):
    """The meta-fit's own fit is made to end at DEGENERATE (the card's
    float32 rounding, which the CPU does not reproduce); the sweep route
    then refits task 2, the Cholesky route has nothing to refit."""
    real = tm.finalize_source_stack
    calls = []

    def ends_degenerate(data, cfg, params):
        calls.append(data.X.shape[0])
        return real(data, cfg, study["params"] if len(calls) == 1 else params)

    monkeypatch.setattr(tm, "finalize_source_stack", ends_degenerate)
    stack = tm.meta_fit_task_stack(study["tdata"], tgp.source_gp_config(),
                                   num_steps=STEPS, mll_method=mll_method,
                                   init_stack=study["init"])
    ok = finite_tasks(stack.chol, stack.alpha)
    if mll_method == "sweep":
        assert calls == [M, 1] and ok.all()
    else:
        assert calls == [M]
        np.testing.assert_array_equal(ok, np.arange(M) != TASK)
