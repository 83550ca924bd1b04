"""Port parity: the sequential-driver bench (``bench_sequential_driver``)
against ``scripts/bench_sequential_driver.py``, on the CPU at a tiny size.

The JAX script's ``run_scenario`` runs with its ``ScaMLGPBO`` replaced by
a recorder that keeps the search space and meta-data it is given and
proposes fixed configurations, so nothing of the JAX driver runs: the
meta-data and the objective's values at those configurations equal the
port's ``scenario_inputs`` bit for bit (both numpy draws from
``default_rng(seed)``).  A tiny scenario then runs through the port's
``ScaMLGPBO`` on the CPU.
"""

import importlib.util
import os
import types

import pytest
import torch

import scamlgp_tpu.bo.optimizer as joptimizer
from scamlgp_tpu_torch import bench_sequential_driver as sb
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {"M": 3, "Nm": 7, "evals": 3, "d": 4}


def _configs(d, n):
    return [{f"x{j}": (0.13 * (i + 1) + 0.21 * j) % 1.0 for j in range(d)}
            for i in range(n)]


class RecordingBO:
    """Stands in for ``ScaMLGPBO``: proposes ``_configs`` and records the
    space, the meta-data and the reported losses."""

    made = []

    def __init__(self, space, objective, meta, seed=None, **kwargs):
        self.space, self.meta, self.losses = space, meta, []
        self.proposals = iter(_configs(len(space), SPEC["evals"]))
        RecordingBO.made.append(self)

    def generate_evaluation_specification(self):
        return types.SimpleNamespace(configuration=next(self.proposals))

    def report(self, evaluation):
        self.losses.append(evaluation.objectives["loss"])


def test_meta_data_and_objective_equal_the_jax_scripts(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_bench_sequential_driver",
        os.path.join(ROOT, "scripts", "bench_sequential_driver.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SCENARIOS == sb.SCENARIOS
    RecordingBO.made.clear()
    monkeypatch.setattr(joptimizer, "ScaMLGPBO", RecordingBO)
    row = mod.run_scenario("hpobench", SPEC, seed=3)
    assert row["scenario"] == "hpobench"
    jbo = RecordingBO.made[0]
    space, objective_fn, meta = sb.scenario_inputs(SPEC, seed=3)
    assert space.get_parameter_names() == jbo.space.get_parameter_names()
    assert space.get_continuous_bounds() == \
        jbo.space.get_continuous_bounds()
    assert list(meta) == list(jbo.meta)
    for task in meta:
        assert len(meta[task]) == SPEC["Nm"]
        for a, b in zip(meta[task], jbo.meta[task]):
            assert a.configuration == b.configuration
            assert a.objectives == b.objectives
    assert [objective_fn(c) for c in _configs(SPEC["d"], SPEC["evals"])] \
        == jbo.losses


def test_tiny_scenario_runs(capsys, monkeypatch):
    """The CLI on a scenario cut to 3 meta-tasks x 8 points, d = 2, 2
    evaluations."""
    monkeypatch.setitem(sb.SCENARIOS, "hpobench",
                        {"M": 3, "Nm": 8, "evals": 2, "d": 2})
    out = sb.main(["--scenarios", "hpobench", "--device", "cpu"])
    assert out["card"] == "cpu" and len(out["rows"]) == 1
    row = out["rows"][0]
    assert (row["M"], row["Nm"], row["d"], row["evals"]) == (3, 8, 2, 2)
    assert row["dtype"] == "float64"
    stages = row["stages"]
    assert stages["meta_fit_s"] > 0 and stages["refit_total_s"] > 0
    assert stages["acquisition_total_s"] > 0
    assert row["per_iter_median_s"] > 0
    assert isinstance(row["outlier_iters"], list)
    assert capsys.readouterr().out.count("\n") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sb.run_scenario("hpobench", SPEC)
