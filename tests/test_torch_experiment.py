"""Port parity of the experiment layer (``benchmarking/
experiment_config_utils.py``, ``utils.py``, ``plotting.py``,
``local_runner.main`` and the 17 configuration modules), on the CPU.

Against the JAX package: every experiment of every configuration module
parses to the same simple-type configuration and hashes to the same
fingerprint (the port writes its own package's dotted names as the JAX
package's), so both packages key the same results directory; ``main``
writes ``info.json`` and ``{key}_{seed}_{hash}.json`` where the JAX
``_results_dir`` puts them; the campaign routing predicates answer as the
JAX ones on the cases of ``tests/benchmarking/test_runner.py``; and the
numpy regret helpers give the JAX values on the same study dicts.  No JAX
campaign or study runs here.
"""

import dataclasses
import importlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from scamlgp_tpu.benchmarking import local_runner as jlr
from scamlgp_tpu.benchmarking import plotting as jplot
from scamlgp_tpu.benchmarking import utils as jutils
from scamlgp_tpu.benchmarking.benchmarks import (
    Branin as JBranin,
    Quadratic as JQuadratic,
)
from scamlgp_tpu.benchmarking.experiment_config_utils import (
    hash_experiment_config as jhash,
    parse_experiment_config as jparse,
)
from scamlgp_tpu.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise as JNoise,
)
from scamlgp_tpu.bo.optimizer import ScaMLGPBO as JScaMLGPBO
from scamlgp_tpu_torch.benchmarking import local_runner as tlr
from scamlgp_tpu_torch.benchmarking import plotting as tplot
from scamlgp_tpu_torch.benchmarking import utils as tutils
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    PD1 as TPD1,
    Branin as TBranin,
    Quadratic as TQuadratic,
)
from scamlgp_tpu_torch.benchmarking.configurations.styles import (
    OPTIMIZER_STYLES,
)
from scamlgp_tpu_torch.benchmarking.experiment_config_utils import (
    Experiment,
    hash_experiment_config,
    parse_experiment_config,
)
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import (
    HomoscedasticGaussianNoise,
)
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.core import Objective

from tests.benchmarking.test_tabular import (  # noqa: F401  (fixtures)
    fcnet_files,
    pd1_file,
)
from tests.torch_threads import one_thread  # noqa: F401

MODULES = ["branin", "hartmann3", "hartmann6",
           "branin_ablation_num_meta_tasks",
           "branin_ablation_num_points_per_task",
           "hartmann6_ablation_num_meta_tasks",
           "hartmann6_ablation_num_points_per_task", "figure_synthetic",
           "ablations_summary", "lr_tabular", "svm_tabular", "rf_tabular",
           "xgb_tabular", "nn_tabular", "fcnet_tabular", "pd1", "figure_hpo"]
CONFIGS = "benchmarking.configurations"
DOCS = Path(__file__).resolve().parents[1] / "docs"


@pytest.mark.parametrize("name", MODULES)
def test_configuration_module_hashes_equal_jax(name, capsys):
    """Same keys, same parsed configurations and same hashes as the JAX
    module; the ``hash`` CLI prints them."""
    j = importlib.import_module(f"scamlgp_tpu.{CONFIGS}.{name}").EXPERIMENTS
    t = importlib.import_module(
        f"scamlgp_tpu_torch.{CONFIGS}.{name}").EXPERIMENTS
    assert list(t) == list(j)
    for key in j:
        assert parse_experiment_config(t[key].__dict__) == jparse(
            j[key].__dict__), key
        assert hash_experiment_config(t[key]) == jhash(j[key]), key
    tutils.run_experiment_cli(f"scamlgp_tpu_torch.{CONFIGS}.{name}", t,
                              lambda results: None, ["hash", "all"])
    printed = capsys.readouterr().out.splitlines()[1:]
    assert printed == [f"{jhash(e)} {k}" for k, e in j.items()]


def test_experiment_hash_semantics():
    """``tests/benchmarking/test_runner.py:51-73`` on the port: ``compute``
    and data paths are left out of the fingerprint; the short hash has 7
    characters; simple types are parsed as the JAX package parses them."""
    def exp(**kw):
        base = dict(optimizer=ScaMLGPBO, benchmark=TQuadratic,
                    n_evaluations=5, n_studies=2, compute="PARALLEL")
        return Experiment(**{**base, **kw})

    assert hash_experiment_config(exp()) == hash_experiment_config(
        exp(compute="LOCAL"))
    assert exp() == exp(compute="LOCAL") and exp() != exp(n_evaluations=6)
    assert len(hash_experiment_config(exp(), short=True)) == 7
    bench = [{"cls": TQuadratic, "kwargs": {"data_dir": d}}
             for d in ("/a/b", "/c/d")]
    assert hash_experiment_config(exp(benchmark=bench[0])) == \
        hash_experiment_config(exp(benchmark=bench[1]))
    value = {"cls": TQuadratic, "n": "3", "x": "1.5", "s": "abc",
             "nested": [TQuadratic, 2],
             "noise": HomoscedasticGaussianNoise({"loss": 0.3})}
    jvalue = dict(value, cls=JQuadratic, nested=[JQuadratic, 2],
                  noise=JNoise({"loss": 0.3}))
    assert parse_experiment_config(value) == jparse(jvalue)
    assert parse_experiment_config(value)["cls"] == (
        "scamlgp_tpu.benchmarking.benchmarks.quadratic.Quadratic")


def test_main_writes_where_jax_reads(tmp_path, caplog, monkeypatch,
                                    capsys):
    """``main`` on ``BRANIN_T8_P32_N1_SCAMLGP`` cut to 2 studies x 2
    evaluations (its width, 8 tasks x 32 points and noise 1.0, kept), on
    the CPU: routed through the campaign, with ``info.json`` and
    ``{key}_{seed}_{hash}.json`` in the directory the JAX ``_results_dir``
    computes, read back by both packages' ``load_results_from_disk`` and
    summarized by ``experiment_regret`` against a committed row; it
    raises without a GPU when no device is named."""
    from scamlgp_tpu_torch.benchmarking import experiment_regret
    from scamlgp_tpu.benchmarking.configurations import branin as jbranin
    from scamlgp_tpu_torch.benchmarking.configurations import branin

    key, module = "BRANIN_T8_P32_N1_SCAMLGP", f"scamlgp_tpu_torch.{CONFIGS}" \
        ".branin"
    config = dataclasses.replace(branin.EXPERIMENTS[key], n_studies=2,
                                 n_evaluations=2)
    jconfig = dataclasses.replace(jbranin.EXPERIMENTS[key], n_studies=2,
                                  n_evaluations=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlr.main(config, module, key, 1, output_root=tmp_path)
    with caplog.at_level(logging.WARNING, logger="scamlgp_tpu_torch.runner"):
        out = tlr.main(config, module, key, 1, output_root=tmp_path,
                       device="cpu")
    assert any("lock-step campaign" in r.message for r in caplog.records)
    assert out == jutils._results_dir(module, key, jconfig, tmp_path)
    h = jhash(jconfig)
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["info.json"] + [f"{key}_{s}_{h}.json" for s in (0, 1)])
    info = json.loads((out / "info.json").read_text())
    assert info["experiment_config"] == jparse(jconfig.__dict__)
    mine = tutils.load_results_from_disk({key: config}, module, tmp_path)
    theirs = jutils.load_results_from_disk({key: jconfig}, module, tmp_path)
    assert mine == theirs
    studies = mine[key]["studies"]
    assert sorted(s["seed"] for s in studies) == [0, 1]
    regret = tplot._regret_curves(studies)
    assert regret.shape == (2, 2) and np.isfinite(regret).all()
    monkeypatch.setitem(branin.EXPERIMENTS, key, config)
    capsys.readouterr()
    line = experiment_regret.main([
        "branin", key, "--output-root", str(tmp_path), "--compare",
        str(DOCS / "branin_t8_p32_n1_regrets_tpu_128studies.npy")])
    assert json.loads(capsys.readouterr().out) == line
    assert line["studies"] == 2 and line["evaluations"] == 2
    assert line["median_regret"] == list(np.median(regret, axis=0))
    assert line["compare"]["ref_studies"] == 128


def test_host_runner_fallback_is_logged(tmp_path, caplog):
    """An experiment the campaign cannot run (custom driver settings) runs
    study by study through ``run_study`` on the named device, in process,
    and the fallback and its reason are logged, as
    ``tests/benchmarking/test_runner.py``'s fallback test holds for the
    JAX package."""
    fast = {"num_restarts_log_likelihood": 1, "num_fit_steps": 8,
            "af_optimizer_kwargs": {"raw_samples": 32, "num_restarts": 2,
                                    "num_steps": 4}}
    config = Experiment(optimizer={"cls": ScaMLGPBO, "kwargs": fast},
                        benchmark={"cls": TQuadratic,
                                   "kwargs": {"n_data_per_task": [6] * 2}},
                        n_evaluations=2, n_studies=1, compute="LOCAL")
    with caplog.at_level(logging.WARNING, logger="scamlgp_tpu_torch.runner"):
        out = tlr.main(config, f"scamlgp_tpu_torch.{CONFIGS}.test_exp",
                       "FALLBACK", 4, output_root=tmp_path, device="cpu")
    (msg,) = [r.message for r in caplog.records]
    assert "sequential host runner" in msg and "not campaign-routable" in msg
    assert "device=cpu, 4 processes" in msg
    (f,) = [p for p in out.glob("*.json") if p.name != "info.json"]
    (study,) = json.loads(f.read_text())["studies"]
    assert len(study["evaluations"]) == 2 and study["seed"] == 0


def _routing_cases():
    """(port args, JAX args) of ``_campaign_routable``: the cases of
    ``tests/benchmarking/test_runner.py:217-247``."""
    class FakeTabular:
        pass

    kw, noise, jnoise = ({"n_data_per_task": [4]},
                         HomoscedasticGaussianNoise({"loss": 0.3}),
                         JNoise({"loss": 0.3}))
    cases = [({}, kw), ({"fit_method": "hmc"}, kw),
             ({"fit_method": "nuts"}, kw), ({"fit_method": "vi"}, kw),
             ({"fit_method": "laplace"}, kw), ({"num_fit_steps": 5}, kw),
             ({}, {"n_data_per_task": []})]
    out = [((ScaMLGPBO, o, TQuadratic, b, noise),
            (JScaMLGPBO, o, JQuadratic, b, jnoise)) for o, b in cases]
    out.append(((ScaMLGPBO, {}, FakeTabular, kw, noise),
                (JScaMLGPBO, {}, FakeTabular, kw, jnoise)))
    out.append(((ScaMLGPBO, {}, TBranin, kw, None),
                (JScaMLGPBO, {}, JBranin, kw, None)))
    return out


def test_routing_predicates_answer_as_jax(fcnet_files, pd1_file):
    """``_campaign_routable`` and ``_tabular_campaign_routable`` give the
    JAX answers; the tabular one on PD1, the FCNet fixture (discrete, with
    and without noise or optimizer kwargs) and a synthetic benchmark."""
    from scamlgp_tpu.benchmarking.benchmarks import (
        PD1 as JPD1,
        FCNetFixedFidelityTabularBenchmark as JFCNet,
    )
    from scamlgp_tpu_torch.benchmarking.benchmarks import (
        FCNetFixedFidelityTabularBenchmark as TFCNet,
    )
    from tests.benchmarking.test_tabular import FCNET_FIXED

    answers = [(tlr._campaign_routable(*t), jlr._campaign_routable(*j))
               for t, j in _routing_cases()]
    assert [a for a, _ in answers] == [b for _, b in answers]
    assert [a for a, _ in answers] == [True] * 4 + [False] * 4 + [True]

    target, metas, _ = fcnet_files
    fk = {"target_task_file": target, "meta_task_files": metas[:1],
          "n_data_per_task": [4], "fix_search_space": FCNET_FIXED}
    pk = {"n_data_per_task": [4], "data_file": pd1_file}
    tab = [((TFCNet, JFCNet), {}, fk, None), ((TPD1, JPD1), {}, pk, None),
           ((TFCNet, JFCNet), {"fit_method": "hmc"}, fk, None),
           ((TFCNet, JFCNet), {"num_fit_steps": 5}, fk, None),
           ((TPD1, JPD1), {}, pk, "noise"),
           ((TQuadratic, JQuadratic), {}, {"n_data_per_task": [4]}, None)]
    for (tcls, jcls), okw, bkw, noise in tab:
        got = tlr._tabular_campaign_routable(
            ScaMLGPBO, okw, tcls, bkw,
            HomoscedasticGaussianNoise({"loss": 0.1}) if noise else None)
        want = jlr._tabular_campaign_routable(
            JScaMLGPBO, okw, jcls, bkw,
            JNoise({"loss": 0.1}) if noise else None)
        assert got == want, (tcls.__name__, okw, noise)
    assert tlr._tabular_campaign_routable(ScaMLGPBO, {"device": "cpu"},
                                          TPD1, pk, None)


def _studies(rng, n_studies, n_evals, noisy):
    studies = []
    for s in range(n_studies):
        losses = np.abs(rng.normal(2.0, 1.0, size=n_evals)) + 0.01
        evals = []
        for i in range(n_evals):
            obj = ({"loss (noisy)": float(losses[i] + 0.1),
                    "loss (noise free)": float(losses[i])} if noisy
                   else {"loss": float(losses[i])})
            evals.append({"configuration": {"x": 0.1 * i},
                          "objectives": obj})
        studies.append({"optimum": float(rng.uniform(-0.5, 0.0)),
                        "objectives": [{"name": "loss",
                                        "greater_is_better": False}],
                        "evaluations": evals, "seed": s})
    return studies


@pytest.mark.parametrize("noisy", [False, True])
def test_regret_helpers_equal_jax(noisy):
    """``compute_regrets``, ``_regret_curves`` (recorded, scalar and
    per-study optima), the average cumulative regret and its SEM, the
    study-wise optima and the best-so-far curves equal the JAX package's
    on the same study dicts."""
    studies = _studies(np.random.default_rng(3), 5, 7, noisy)
    for override in (None, -0.75, [-0.1 * i for i in range(5)]):
        np.testing.assert_array_equal(
            tplot._regret_curves(studies, override),
            jplot._regret_curves(studies, override))
    assert tplot._compute_average_cum_regret(studies) == \
        jplot._compute_average_cum_regret(studies)
    assert tplot._compute_sem_cum_regret(studies) == \
        jplot._compute_sem_cum_regret(studies)
    obj = tplot._study_objective(studies[0])
    assert obj.name == ("loss (noise free)" if noisy else "loss")
    data = [{"studies": studies}, {"studies": studies[:3]}]
    assert tplot._study_wise_optima(data, obj) == jplot._study_wise_optima(
        data, obj)
    np.testing.assert_array_equal(
        tplot._cummin_objective_curves(studies, obj),
        jplot._cummin_objective_curves(studies, obj))
    values = [e["objectives"] for e in studies[0]["evaluations"]]
    assert tplot.compute_regrets(obj, 0.0, values) == jplot.compute_regrets(
        obj, 0.0, values)


def test_figures_draw_with_agg(tmp_path):
    """``grouped_results`` draws the regret grid, and
    ``plot_meta_data_summary_comparison`` the ablation errorbars from
    parsed configurations (the optimizer written under the JAX package's
    name), with matplotlib's Agg backend."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(4)
    config = Experiment(optimizer=ScaMLGPBO,
                        benchmark={"cls": "B",
                                   "kwargs": {"n_data_per_task": [4] * 2}},
                        n_evaluations=6, n_studies=4, compute="X")
    runs = [{"experiment_config": config.__dict__,
             "studies": _studies(rng, 4, 6, False)}]
    for robust, regrets in ((True, True), (False, False)):
        fig = tplot.grouped_results(
            runs, optimizer_styles=OPTIMIZER_STYLES, groups={"G": [config]},
            robust_statistics=robust, objective=Objective("loss", False),
            use_regrets=regrets)
        assert len(fig.axes) == 1 and fig.axes[0].lines
        fig.savefig(tmp_path / "grid.png")
        plt.close(fig)
    results = {}
    for m in (2, 4):
        c = dataclasses.replace(config, benchmark={
            "cls": "B", "kwargs": {"n_data_per_task": [8] * m}})
        results[f"T{m}"] = {
            "experiment_config": parse_experiment_config(c.__dict__),
            "studies": _studies(rng, 3, 6, False)}
    fig, ax = plt.subplots()
    tplot.plot_meta_data_summary_comparison(
        results, styles=OPTIMIZER_STYLES, ax=ax, num_points_per_task=8)
    assert ax.containers
    plt.close(fig)

