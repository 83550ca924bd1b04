"""Port parity of the tabular benchmarks' device adapters
(``benchmarking/tabular_adapters.py``) and the table campaigns, on the CPU.

Against the JAX package, in float64: the batched grid gather and the
batched masked L1 argmin equal the JAX per-study lookups bit for bit on
random points (bin edges included), and ``campaign_inputs_from_grid_tabular``
/ ``campaign_inputs_from_pd1`` give the same tables, meta ``TaskData`` and
optima on the FCNet, HPOBench-stub and PD1 fixtures of
``tests/benchmarking/test_tabular.py``.  The JAX campaign does not run here.

Port contracts: each study's device value is the benchmark's own host
lookup of ``from_numerical(x)``; a table campaign runs through
``local_runner.main`` on the CPU and persists table values; a stopped and
resumed table campaign, and one in study chunks, equal the uninterrupted
one bit for bit (their ``task_params`` hold ``(S, G)``, ``(S, R, d)`` and
bool leaves).
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.benchmarking import tabular_adapters as jta
from scamlgp_tpu.benchmarking.benchmarks.fcnet_fixed_fidelity_tabular import (
    FCNetFixedFidelityTabularBenchmark as JFCNet,
)
from scamlgp_tpu_torch.benchmarking import local_runner as lr
from scamlgp_tpu_torch.benchmarking import tabular_adapters as tta
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    PD1 as TPD1,
    FCNetFixedFidelityTabularBenchmark as TFCNet,
    HPOBenchTabular as THPOBench,
)
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import Experiment
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.core import EvaluationSpecification
from scamlgp_tpu_torch.parallel import campaign as tc

from tests.benchmarking.test_tabular import (  # noqa: F401  (fixtures)
    FCNET_FIXED,
    fcnet_files,
    hpobench_stub,
    pd1_file,
)
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
CFG = tc.CampaignConfig(n_evaluations=3, noise_std=0.0, fit_steps=10,
                        fit_restarts=1, acq_raw_samples=32, acq_topk=2,
                        acq_steps=5)
KW = dict(cfg=CFG, meta_fit_restarts=1, meta_fit_steps=8, device="cpu")


def _unit_points(rng, S, d, n_levels=None):
    """Uniform points, a few outside the cube, and (for a grid) exact bin
    edges ``k / n`` with 0 and 1."""
    x = rng.uniform(-0.05, 1.05, size=(S, d))
    if n_levels is not None:
        for k, n in enumerate(n_levels):
            x[::2, k] = rng.integers(0, n + 1, size=x[::2, k].shape) / n
    return x


def test_grid_lookup_equals_jax_bitwise():
    """The batched gather over (S, G) tables equals the JAX per-study
    ``fn`` on every study's row, in float64, bit for bit."""
    rng = np.random.default_rng(0)
    n_levels, S = (2, 6, 3), 7
    table = rng.normal(size=(S, int(np.prod(n_levels))))
    jfn = jta.make_grid_lut_fn(n_levels)
    tfn = tta.make_grid_lut_fn(n_levels)
    for _ in range(5):
        x = _unit_points(rng, S, len(n_levels), n_levels)
        got = tfn(torch.as_tensor(x), {"table": torch.as_tensor(table)})
        want = [float(jfn(jnp.asarray(x[s]), {"table": jnp.asarray(table[s])}))
                for s in range(S)]
        assert got.dtype == F64 and got.shape == (S,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_nn_lookup_equals_jax_bitwise():
    """The batched masked L1 argmin over (S, R, d) rows, with padded rows
    masked out, equals the JAX per-study ``fn`` bit for bit in float64."""
    rng = np.random.default_rng(1)
    S, R, d = 6, 40, 4
    lower, upper = rng.uniform(-3, 0, size=d), rng.uniform(0.5, 3, size=d)
    coords = lower + (upper - lower) * rng.uniform(size=(S, R, d))
    values = rng.normal(size=(S, R))
    valid = np.arange(R)[None, :] < rng.integers(5, R + 1, size=(S, 1))
    jfn = jta.make_nn_lut_fn(lower, upper)
    tfn = tta.make_nn_lut_fn(lower, upper)
    tp = {"coords": torch.as_tensor(coords), "values": torch.as_tensor(values),
          "valid": torch.as_tensor(valid)}
    for _ in range(5):
        x = _unit_points(rng, S, d)
        got = tfn(torch.as_tensor(x), tp)
        want = [float(jfn(jnp.asarray(x[s]),
                          {"coords": jnp.asarray(coords[s]),
                           "values": jnp.asarray(values[s]),
                           "valid": jnp.asarray(valid[s])}))
                for s in range(S)]
        np.testing.assert_array_equal(got.numpy(), want)


def _factories(kind, fcnet_files, pd1_file):
    """(JAX factory, port factory, input function name) of one fixture."""
    if kind == "fcnet":
        target, metas, _ = fcnet_files
        kw = dict(target_task_file=target, meta_task_files=metas,
                  n_data_per_task=[4, 5], fix_search_space=FCNET_FIXED)
        return (lambda s: JFCNet(seed=s, **kw), lambda s: TFCNet(seed=s, **kw),
                "campaign_inputs_from_grid_tabular")
    if kind == "hpobench":
        from scamlgp_tpu.benchmarking.benchmarks.hpo_bench_tabular import (
            HPOBenchTabular as JHPOBench,
        )
        return (lambda s: JHPOBench("svm", n_data_per_task=[3, 4], seed=s),
                lambda s: THPOBench("svm", n_data_per_task=[3, 4], seed=s),
                "campaign_inputs_from_grid_tabular")
    from scamlgp_tpu.benchmarking.benchmarks.pd1 import PD1 as JPD1

    return (lambda s: JPD1(n_data_per_task=[4, 3], seed=s, data_file=pd1_file),
            lambda s: TPD1(n_data_per_task=[4, 3], seed=s, data_file=pd1_file),
            "campaign_inputs_from_pd1")


@pytest.mark.parametrize("kind", ["fcnet", "hpobench", "pd1"])
def test_campaign_inputs_equal_jax(kind, fcnet_files, pd1_file,
                                   hpobench_stub):
    """Tables, meta TaskData and optima equal the JAX input functions' on
    the same fixture and seeds (float64; PD1's meta rows are drawn by
    pandas from numpy's global generator, seeded alike before each
    build), and each study's device value is its benchmark's host lookup
    of ``from_numerical(x)``."""
    jfac, tfac, inputs_fn = _factories(kind, fcnet_files, pd1_file)
    seeds = [0, 1, 2]
    np.random.seed(5)
    jfn, jtp, jmd, jopt = getattr(jta, inputs_fn)(jfac, seeds,
                                                dtype=jnp.float64)
    np.random.seed(5)
    tfn, ttp, tmd, topt = getattr(tta, inputs_fn)(tfac, seeds, dtype=F64,
                                                device="cpu")
    assert sorted(jtp) == sorted(ttp)
    for k in jtp:
        np.testing.assert_array_equal(ttp[k].numpy(), np.asarray(jtp[k]))
    for f, a, b in zip(tmd._fields, tmd, jmd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14, err_msg=f)
    np.testing.assert_array_equal(topt, jopt)

    rng = np.random.default_rng(2)
    d = tmd.X.shape[-1]
    x = rng.uniform(size=(len(seeds), d))
    got = tfn(torch.as_tensor(x), ttp)
    for s, seed in enumerate(seeds):
        b = tfac(seed)
        if kind == "hpobench":   # continuous C: the bin centre's value
            lv = tta.grid_levels(b.search_space)
            cfg = {p.name: v[min(int(u * len(v)), len(v) - 1)]
                   for p, v, u in zip(tta._free_params(b.search_space), lv,
                                      x[s])}
        else:
            cfg = b.search_space.from_numerical(x[s])
        host = b(EvaluationSpecification(configuration=cfg))
        assert float(got[s]) == host.objectives[b.objectives[0].name]


def _fcnet_experiment(fcnet_files, **kw):
    target, metas, _ = fcnet_files
    return Experiment(
        optimizer=ScaMLGPBO,
        benchmark={"cls": TFCNet,
                   "kwargs": {"target_task_file": target,
                              "meta_task_files": metas[:1],
                              "n_data_per_task": [4],
                              "fix_search_space": FCNET_FIXED}},
        compute="LOCAL", **kw)


def test_table_campaign_through_main_on_cpu(fcnet_files, tmp_path, caplog):
    """``main`` routes a default-optimizer FCNet experiment through the
    table campaign on the CPU (2 studies x 2 evaluations) and persists the
    standard per-seed layout, every observation a value of the table."""
    _, _, expected = fcnet_files
    config = _fcnet_experiment(fcnet_files, n_evaluations=2, n_studies=2)
    assert lr._tabular_campaign_routable(
        ScaMLGPBO, {"device": "cpu"}, TFCNet, config.benchmark["kwargs"],
        None)
    with caplog.at_level(logging.WARNING, logger="scamlgp_tpu_torch.runner"):
        out_dir = lr.main(config, "scamlgp_tpu_torch.benchmarking."
                          "configurations.test_exp", "FCNET_DEV", 1,
                          output_root=tmp_path, device="cpu")
    assert any("TABLE campaign" in r.message for r in caplog.records)
    files = sorted(p for p in out_dir.glob("*.json") if p.name != "info.json")
    assert len(files) == 2
    for f in files:
        (study,) = json.loads(f.read_text())["studies"]
        assert len(study["evaluations"]) == 2
        for ev in study["evaluations"]:
            key = TFCNet._lut_key(ev["configuration"])
            assert ev["objectives"]["valid_loss"] == pytest.approx(
                expected[key], rel=1e-6)


@pytest.mark.parametrize("kind", ["fcnet", "pd1"])
def test_table_campaign_resumes_and_chunks_bitwise(kind, fcnet_files,
                                                   pd1_file, tmp_path):
    """A table campaign stopped after one iteration and resumed, and one in
    study chunks of 1, equal the uninterrupted campaign bit for bit: the
    checkpoint and the chunks carry the (S, G) tables, or the (S, R, d)
    rows, (S, R) values and bool mask."""
    _, tfac, inputs_fn = _factories(kind, fcnet_files, pd1_file)
    np.random.seed(0)
    fn, tp, md, _ = getattr(tta, inputs_fn)(tfac, [0, 1], dtype=F64,
                                          device="cpu")
    whole = tc.run_campaign(fn, tp, md, **KW)
    path = tmp_path / "ckpt"
    stopped = tc.run_campaign(fn, tp, md, checkpoint_path=path,
                              stop_after=1, **KW)
    assert int(stopped.mask.sum(-1).min()) == 1
    resumed = tc.run_campaign(fn, tp, md, checkpoint_path=path, **KW)
    chunked = tc.run_campaign(fn, tp, md, study_chunk=1, **KW)
    for run in (resumed, chunked):
        for f in ("X", "y", "y_clean"):
            assert torch.equal(getattr(whole, f), getattr(run, f)), f
    values = (tp["table"] if kind == "fcnet" else tp["values"]).numpy()
    for s in range(2):
        assert set(whole.y_clean[s].tolist()) <= set(values[s].tolist())


def test_inputs_go_to_the_card_unless_told(pd1_file):
    """With no device named the input functions put the tables on ``cuda``: where
    none is available they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, tfac, _ = _factories("pd1", None, pd1_file)
    for build in (tta.campaign_inputs_from_pd1,
                  tta.campaign_inputs_from_grid_tabular):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tfac, [0])
