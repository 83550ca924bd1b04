"""Port parity: the table-campaign bench (``bench_tabular_campaign``) against
``scripts/bench_tabular_campaign.py``, on the CPU at a tiny size.

The JAX script's ``main`` runs with its ``run_campaign`` replaced by a
recorder, so nothing of the JAX campaign runs: its synthetic tables, meta
``X``/``y``/``mean``/``std``, optima and campaign settings are captured
and held to the port's, bit for bit (both are numpy float32 draws from
``default_rng(0)``).  The script's process-wide settings (the JAX
compilation cache and ``SCAMLGP_ITER_DEBUG``) are restored after it.  A
tiny campaign then runs end to end through the port.
"""

import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import scamlgp_tpu.parallel.campaign as jcampaign
from jax._src import compilation_cache
from scamlgp_tpu_torch import bench_tabular_campaign as tb
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--levels", "4,3", "--tasks", "3", "--points", "5", "--evals", "2",
        "--studies", "4", "--meta-fit-chunks", "2", "--mll-method", "sweep"]
S, M, N, E = 4, 3, 5, 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Stands in for ``run_campaign``: records its call, returns zeros."""

    def __init__(self, zeros):
        self.zeros, self.calls = zeros, []

    def __call__(self, fn, task_params, meta, *args, **kwargs):
        self.calls.append((fn, task_params, meta, args, kwargs))
        return types.SimpleNamespace(
            y_clean=self.zeros((S, E)), meta_fit_seconds=0.0,
            iteration_seconds=[], launches={})


@pytest.fixture
def jax_capture(monkeypatch, tmp_path):
    """The JAX script's ``main`` on ARGS with a recording ``run_campaign``,
    in ``tmp_path``; the JAX settings it changes are put back."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SCAMLGP_ITER_DEBUG", "1")
    rec = Recorder(lambda shape: jax.numpy.zeros(shape))
    monkeypatch.setattr(jcampaign, "run_campaign", rec)
    monkeypatch.setattr(sys, "argv", ["bench_tabular_campaign.py", *ARGS])
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        _script("bench_tabular_campaign").main()
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
    assert len(rec.calls) == 1
    return rec.calls[0]


def test_inputs_equal_the_jax_scripts(jax_capture, monkeypatch, capsys):
    jfn, jtp, jmeta, jargs, jkw = jax_capture
    rec = Recorder(torch.zeros)
    monkeypatch.setattr(tb, "run_campaign", rec)
    out = tb.main([*ARGS, "--device", "cpu"])
    fn, tp, meta, args, kw = rec.calls[0]
    np.testing.assert_array_equal(tp["table"].numpy(),
                                  np.asarray(jtp["table"]))
    for name in ("X", "y", "mask", "mean", "std"):
        a, b = getattr(meta, name), np.asarray(getattr(jmeta, name))
        assert a.dtype == torch.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(a.numpy(), b)
    # the same campaign settings and lookups
    for key in ("n_evaluations", "noise_std", "mll_method"):
        assert getattr(kw["cfg"], key) == getattr(jkw["cfg"], key)
    assert (kw["meta_fit_chunks"], kw["study_chunk"]) == (
        jkw["meta_fit_chunks"], jkw["study_chunk"])
    x = np.random.default_rng(1).uniform(size=(S, 2))
    np.testing.assert_array_equal(
        fn(torch.as_tensor(x, dtype=torch.float32), tp).numpy(),
        np.asarray(jax.vmap(jfn)(jax.numpy.asarray(x, jax.numpy.float32),
                                 jtp)))
    # regret of zeros against the optima: minus each table's minimum
    tables = np.asarray(jtp["table"])
    assert out["median_final_regret_synthetic"] == pytest.approx(
        float(np.median(-tables.min(axis=1))))
    assert "seq_driver_studies_per_hour" not in out
    assert "speedup_vs_seq_driver" not in out
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "studies"] == S


def test_sequential_driver_comparison(tmp_path, monkeypatch):
    """``--seq-driver-json`` takes the hpobench row's median iteration."""
    path = tmp_path / "seq.json"
    path.write_text(json.dumps({"rows": [
        {"scenario": "fcnet", "per_iter_median_s": 9.0},
        {"scenario": "hpobench", "per_iter_median_s": 0.5}]}))
    monkeypatch.setattr(tb, "run_campaign", Recorder(torch.zeros))
    out = tb.run((4, 3), M, N, E, S, 2, None, "chol", str(path), "cpu")
    assert out["seq_driver_studies_per_hour"] == pytest.approx(3600 / 1.0)
    assert out["speedup_vs_seq_driver"] == pytest.approx(
        S / out["campaign_s"] * 0.5 * E)
    path.write_text(json.dumps({"rows": []}))
    with pytest.raises(ValueError, match="no hpobench row"):
        tb.seq_driver_iteration_s(str(path))


def test_tiny_campaign_runs_end_to_end():
    out = tb.run((4, 4), tasks=2, points=5, evals=2, studies=2,
                 meta_fit_chunks=2, mll_method="sweep", device="cpu")
    assert out["campaign_s"] > 0 and len(out["iteration_s"]) == 2
    assert np.isfinite(out["median_final_regret_synthetic"])
    assert out["median_final_regret_synthetic"] >= 0
    assert "iteration_fit_target" in out["stages"]
    assert out["launches"] == {}    # plain versions on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.run((4, 4), 2, 5, 2, 2, 2)
