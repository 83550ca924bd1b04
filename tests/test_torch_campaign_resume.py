"""Port parity and contracts of the resumable, study-chunked lock-step
campaign, the ``chol64`` MLL, the Quadratic benchmark and the campaign's
study results, on the CPU in float64 at small sizes.

Against the JAX package: the Quadratic campaign inputs and
``quadratic_unit`` (rtol 1e-12), ``gp.mll(method="chol64")``'s value and
gradient on float32 inputs with a prior mean and covariance (rtol 1e-6 and
1e-5: both compute in float64 and cast to float32), and
``campaign_to_study_results`` on the same arrays (equal dicts).  The JAX
``run_campaign`` does not run here.

Port contracts, those of ``tests/test_parallel.py``'s campaign tests on
Quadratic (2 tasks x 8 points): a stopped and resumed campaign equals the
uninterrupted one, a ``study_chunk=2`` campaign equals the unchunked one
(bit for bit: each iteration's draws are made for all studies and sliced,
and no CPU op here depends on the batch size), a chunk-aware resume of a
checkpoint whose second chunk never ran gives the same result, and the
guards refuse what would resume wrongly.  The campaign routing of
``local_runner`` runs a small experiment end to end, and the batch probe
(``batch_probe.py``) walks two recordings of an iteration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.benchmarking import jax_adapters as ja
from scamlgp_tpu.benchmarking.benchmarks import Quadratic as JQuadratic
from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu_torch.benchmarking import local_runner as lr
from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin as TBranin
from scamlgp_tpu_torch.benchmarking.benchmarks import Quadratic as TQuadratic
from scamlgp_tpu_torch.benchmarking.noise import HomoscedasticGaussianNoise
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.parallel import campaign as tc
from scamlgp_tpu_torch.utils import checkpoint as ckpt

F64 = torch.float64
S, M, NPTS = 4, 2, 8
CFG = tc.CampaignConfig(n_evaluations=3, noise_std=0.05, fit_steps=10,
                        fit_restarts=1, acq_raw_samples=32, acq_topk=2,
                        acq_steps=5)
KW = dict(cfg=CFG, meta_fit_restarts=1, meta_fit_steps=8, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    j = ja.campaign_inputs_from_benchmark(JQuadratic, [NPTS] * M, range(S),
                                          noise_std=0.05, dtype=jnp.float64)
    t = ta.campaign_inputs_from_benchmark(TQuadratic, [NPTS] * M, range(S),
                                          noise_std=0.05, dtype=F64,
                                          device="cpu")
    return j, t


@pytest.fixture(scope="module")
def full(inputs):
    _, (fn, tp, md, _) = inputs
    return tc.run_campaign(fn, tp, md, **KW)


def assert_same(a, b):
    for f in ("X", "y", "y_clean"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy())


def test_quadratic_inputs_match(inputs):
    """Seeded meta-data agree; the targets are drawn unseeded, so each
    side's optimum is held to its own target's analytic minimum c, and the
    two adapters to each other on the same points and parameters."""
    (jfn, _, jmd, _), (tfn, ttp, tmd, topt) = inputs
    for a, b in zip(tmd, jmd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_array_equal(topt.numpy(), ttp["c"].numpy())
    x = np.random.default_rng(0).uniform(size=(S, 1))
    jy = jax.vmap(jfn)(jnp.asarray(x), {k: jnp.asarray(v.numpy())
                                        for k, v in ttp.items()})
    np.testing.assert_allclose(tfn(torch.as_tensor(x), ttp).numpy(),
                               np.asarray(jy), rtol=1e-12)
    vals = tfn(torch.linspace(0, 1, 2001, dtype=F64)[:, None],
               {k: v[:, None] for k, v in ttp.items()})
    assert (vals.min(-1).values >= topt - 1e-12).all()
    assert (vals.min(-1).values - topt < 1e-5).all()


@pytest.mark.parametrize("n,masked", [(16, False), (64, True)])
def test_chol64_matches_jax(n, masked):
    """Branin-like float32 data with a prior mean and covariance."""
    rng = np.random.default_rng(n)
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    y = ((-5 + 15 * X[:, 0]) ** 2 / 50 + np.cos(15 * X[:, 1])).astype(
        np.float32)
    y = (y - y.mean()) / y.std()
    B = rng.normal(size=(n, n)).astype(np.float32)
    cov = (0.1 * B @ B.T / n).astype(np.float32)
    mean = (0.3 * rng.normal(size=n)).astype(np.float32)
    mask = (np.arange(n) < n - 5).astype(np.float32) if masked else None
    raw = (rng.normal(size=2).astype(np.float32),
           np.float32(rng.normal()), np.float32(rng.normal()))
    cfg = jgp.source_gp_config()

    def jf(p):
        return jgp.mll(cfg, p, jnp.asarray(X), jnp.asarray(y),
                       None if mask is None else jnp.asarray(mask),
                       prior_mean=jnp.asarray(mean),
                       prior_cov=jnp.asarray(cov), method="chol64")

    jv, jg = jax.value_and_grad(jf)(jgp.GPParams(*map(jnp.asarray, raw)))
    tp = tgp.GPParams(*[torch.tensor(np.asarray(r), requires_grad=True)
                        for r in raw])
    tv = tgp.mll(tgp.source_gp_config(), tp, torch.tensor(X), torch.tensor(y),
                 None if mask is None else torch.tensor(mask),
                 prior_mean=torch.tensor(mean), prior_cov=torch.tensor(cov),
                 method="chol64")
    assert tv.dtype == torch.float32 and jv.dtype == jnp.float32
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    tv.backward()
    for t, j in zip(tp, jg):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5)


@pytest.mark.parametrize("noisy", [True, False])
def test_campaign_to_study_results_matches_jax(noisy):
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(3, 5, 1))
    y, yc = rng.normal(size=(3, 5)), rng.normal(size=(3, 5))
    optima = rng.normal(size=3)
    seeds = [4, 5, 6]
    jres = tc.CampaignResult(X=X, y=y, y_clean=yc, meta_fit_seconds=0.0,
                             iteration_seconds=[], launches={},
                             nonfinite_source_tasks=0, mask=None)
    tres = jres._replace(X=torch.as_tensor(X), y=torch.as_tensor(y),
                         y_clean=torch.as_tensor(yc))
    j = ja.campaign_to_study_results(JQuadratic, [4] * 2, seeds, jres,
                                     optima, noisy=noisy)
    t = ta.campaign_to_study_results(TQuadratic, [4] * 2, seeds, tres,
                                     torch.as_tensor(optima), noisy=noisy)
    assert t == j
    assert [s["seed"] for s in t] == seeds


def test_chunked_campaign_equals_unchunked(inputs, full):
    _, (fn, tp, md, _) = inputs
    assert_same(tc.run_campaign(fn, tp, md, study_chunk=2, **KW), full)


def test_stopped_and_resumed_campaign_equals_uninterrupted(inputs, full,
                                                           tmp_path):
    _, (fn, tp, md, _) = inputs
    path = tmp_path / "ck"
    part = tc.run_campaign(fn, tp, md, checkpoint_path=path, stop_after=2,
                           **KW)
    assert part.mask.sum(-1).tolist() == [2.0] * S
    assert float(part.X[:, 2:].abs().sum()) == 0.0
    assert len(part.iteration_seconds) == 2
    # targets, meta-data, buffers, target parameters, seed and count
    assert len(ckpt.load_leaves(path)) == len(tp) + 5 + 4 + 4 + 2
    # the targets come from the checkpoint, not from the arguments
    other = {k: v + 0.5 for k, v in tp.items()}
    resumed = tc.run_campaign(fn, other, md, checkpoint_path=path, **KW)
    assert len(resumed.iteration_seconds) == 1
    assert_same(resumed, full)


def _checkpoint_template(tp, md, E, dtype=F64):
    """A ``CampaignState`` of the campaign's shapes, to load into."""
    S_, M_, _, d = md.X.shape
    z = torch.zeros((S_, E), dtype=dtype)
    return tc.CampaignState(
        task_params=tp, meta_data=md, X=torch.zeros((S_, E, d), dtype=dtype),
        y=z, y_clean=z, mask=z,
        params=tm.init_target_params(tgp.target_gp_config(), M_, d, dtype,
                                     batch_shape=(S_,)),
        seed=torch.tensor(0), completed=torch.tensor(0))


def test_chunk_aware_resume_after_a_fault(inputs, full, tmp_path):
    """A chunked, checkpointed run; its checkpoint turned into one written
    after chunk 1 only (chunk 2's buffers back to zero and its parameters
    to their initial values) resumes chunked to the same result, and an
    unchunked resume of it, or one with other chunk bounds, is refused."""
    _, (fn, tp, md, _) = inputs
    path = tmp_path / "ck"
    done = tc.run_campaign(fn, tp, md, study_chunk=2, checkpoint_path=path,
                           **KW)
    assert_same(done, full)
    state = ckpt.load_pytree_like(
        path, _checkpoint_template(tp, md, CFG.n_evaluations))
    assert int(state.completed) == CFG.n_evaluations
    init = tm.init_target_params(tgp.target_gp_config(), M, 1, F64,
                                 batch_shape=(2,))
    for t in (state.X, state.y, state.y_clean, state.mask):
        t[2:] = 0.0
    for full_leaf, ini in zip(tfit.tree_leaves(state.params),
                              tfit.tree_leaves(init)):
        full_leaf[2:] = ini
    ckpt.save_pytree(path, state._replace(completed=torch.tensor(0)))
    with pytest.raises(ValueError, match="study-chunked"):
        tc.run_campaign(fn, tp, md, study_chunk=0, checkpoint_path=path,
                        **KW)
    with pytest.raises(ValueError, match="within study chunk"):
        tc.run_campaign(fn, tp, md, study_chunk=3, checkpoint_path=path,
                        **KW)
    resumed = tc.run_campaign(fn, tp, md, study_chunk=2,
                              checkpoint_path=path, **KW)
    assert len(resumed.iteration_seconds) == CFG.n_evaluations
    assert_same(resumed, full)


def test_campaign_guards(inputs, tmp_path):
    _, (fn, tp, md, _) = inputs
    with pytest.raises(ValueError, match="stop_after"):
        tc.run_campaign(fn, tp, md, study_chunk=2, stop_after=1, **KW)
    with pytest.raises(ValueError, match="checkpoint_every"):
        tc.run_campaign(fn, tp, md, checkpoint_every=0, **KW)
    path = tmp_path / "ck"
    tc.run_campaign(fn, tp, md, checkpoint_path=path, stop_after=1, **KW)
    with pytest.raises(ValueError, match="seed"):
        tc.run_campaign(fn, tp, md, seed=1, checkpoint_path=path, **KW)
    with pytest.raises(ValueError, match="different settings"):
        tc.run_campaign(fn, tp, md, checkpoint_path=path,
                        **dict(KW, cfg=dataclasses.replace(
                            CFG, n_evaluations=5)))


def test_iteration_draws_depend_on_seed_and_iteration_only():
    tcfg = tgp.target_gp_config()
    a, b, c = (tc.iteration_draws(tc.iteration_generator(s, i), CFG, tcfg,
                                  3, M, 1, F64, "cpu")
               for s, i in ((0, 2), (0, 2), (0, 3)))
    assert torch.equal(a.raw, b.raw) and torch.equal(a.noise, b.noise)
    assert not torch.equal(a.raw, c.raw)


def test_campaign_routing(tmp_path):
    """Routable: a synthetic benchmark, the default driver (a MAP
    ``fit_method`` and a ``device`` allowed), homoscedastic loss noise;
    the routed experiment gives ``run_study``'s schema per seed."""
    noise = HomoscedasticGaussianNoise({"loss": 0.05})
    kw = {"n_data_per_task": [4] * 2}
    ok = lr._campaign_routable(ScaMLGPBO, {"device": "cpu"}, TQuadratic, kw,
                               noise)
    assert ok and lr._campaign_routable(ScaMLGPBO, {}, TBranin, kw, None)
    for args in ((ScaMLGPBO, {"fit_method": "hmc"}, TQuadratic, kw, noise),
                 (object, {}, TQuadratic, kw, noise),
                 (ScaMLGPBO, {"seed": 1}, TQuadratic, kw, noise),
                 (ScaMLGPBO, {}, TQuadratic, dict(kw, seed=1), noise),
                 (ScaMLGPBO, {}, TQuadratic, {"n_data_per_task": []}, noise),
                 (ScaMLGPBO, {}, TQuadratic, kw,
                  HomoscedasticGaussianNoise({"other": 0.1}))):
        assert not lr._campaign_routable(*args)
    studies = []
    lr._submit_via_campaign({"device": "cpu"}, TQuadratic, kw, noise, 1, 2,
                            studies.append)
    assert [s["seed"] for s in studies] == [0, 1]
    space = TQuadratic(n_data_per_task=[4] * 2, seed=0).search_space
    for s in studies:
        assert np.isfinite(s["optimum"]) and len(s["evaluations"]) == 1
        for ev in s["evaluations"]:
            assert set(ev["objectives"]) == {"loss (noisy)",
                                             "loss (noise free)"}
            assert space.check_validity(ev["configuration"])


def test_batch_probe_compares_two_recordings():
    """The batch probe's recorder and walk on a tiny float64 CPU iteration
    (where no operation depends on the batch size), and on a synthetic
    pair of recordings in which one does."""
    from scamlgp_tpu_torch import batch_probe as bp

    fn, tp, md, _ = ta.campaign_inputs_from_benchmark(
        TQuadratic, [4] * 2, range(4), noise_std=0.05, dtype=F64,
        device="cpu")
    cfg = dataclasses.replace(CFG, n_evaluations=4, fit_steps=2)
    calls = []
    for S in (4, 2):
        with bp.Recorder(400) as rec:
            bp.iteration(fn, tp, md, S, cfg, "cpu")
        calls.append(rec.calls)
    assert [len(c) for c in calls] == [400, 400]
    found = bp.compare(*calls)
    assert found["compared"] > 0 and found["batch_dependent_op"] is None
    a, b = torch.arange(8.0).reshape(4, 2), torch.arange(4.0).reshape(2, 2)
    full = [("aten.add", [a], [a + 1]), ("aten.sum", [a], [a.sum(0)]),
            ("aten.mul", [a], [a * 2])]
    part = [("aten.add", [b], [b + 1]), ("aten.sum", [b], [b.sum(0)]),
            ("aten.mul", [b], [b * 2 + 1e-6])]
    found = bp.compare(full, part)
    assert found["compared"] == 2
    assert found["batch_dependent_op"]["op"] == "aten.mul"
