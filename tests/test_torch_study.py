"""Port parity: the study unit (``benchmarking/local_runner.py::run_study``
through ``bbo_helper.run_with_bbo``, ``NoisyBenchmark`` and
``HomoscedasticGaussianNoise``) against the JAX package's, on the paper's
Branin T8 N_m=32 experiment (noise 1.0) cut to 3 evaluations, with the
driver's fast test settings, on the CPU in float64.

The meta-data and the noise are host numpy in both packages, so they agree
exactly; the proposals come from each package's own randomness, and the
target task is drawn without the seed in both, so only their validity is
compared.
"""

import numpy as np
import pytest

from scamlgp_tpu.benchmarking import local_runner as jlr
from scamlgp_tpu.benchmarking.benchmarks import Branin as JBranin
from scamlgp_tpu.benchmarking.noise import (
    HomoscedasticGaussianNoise as JNoise,
)
from scamlgp_tpu.bo import optimizer as jopt
from scamlgp_tpu_torch.benchmarking import local_runner as tlr
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin as TBranin
from scamlgp_tpu_torch.benchmarking.noise import (
    HomoscedasticGaussianNoise as TNoise,
)
from scamlgp_tpu_torch.benchmarking.noise import NoisyBenchmark
from scamlgp_tpu_torch.bo import optimizer as topt

FAST_KWARGS = dict(
    num_restarts_log_likelihood=2,
    num_fit_steps=30,
    af_optimizer_kwargs={"raw_samples": 256, "num_restarts": 4,
                         "num_steps": 25},
)
BENCH_KWARGS = {"n_data_per_task": [32] * 8}
EVALS, SEED = 3, 7


def recording(cls, store):
    """``cls`` that keeps the meta-data it is given."""

    class Recording(cls):
        def __init__(self, search_space, objective, meta_data, **kwargs):
            store.append(meta_data)
            super().__init__(search_space, objective, meta_data, **kwargs)

    return Recording


@pytest.fixture(scope="module")
def studies():
    jmeta, tmeta = [], []
    jres = jlr.run_study(recording(jopt.ScaMLGPBO, jmeta), FAST_KWARGS,
                         JBranin, BENCH_KWARGS, EVALS, SEED,
                         JNoise({"loss": 1.0}))
    tres = tlr.run_study(recording(topt.ScaMLGPBO, tmeta),
                         dict(FAST_KWARGS, device="cpu"), TBranin,
                         BENCH_KWARGS, EVALS, SEED, TNoise({"loss": 1.0}))
    return jres, tres, jmeta[0], tmeta[0]


def test_same_meta_data(studies):
    _, _, jmeta, tmeta = studies
    assert list(jmeta) == list(tmeta)
    assert [len(v) for v in tmeta.values()] == [32] * 8
    for uid in jmeta:
        for je, te in zip(jmeta[uid], tmeta[uid]):
            assert je.configuration == te.configuration
            assert je.objectives == te.objectives


def test_same_result_keys_and_noise(studies):
    jres, tres, _, _ = studies
    assert set(tres) == set(jres)
    assert tres["seed"] == jres["seed"] == SEED
    assert tres["objectives"] == jres["objectives"]
    # each study's target task is drawn without the seed (the benchmarks'
    # ``create_tasks``, in both packages), so each optimum is its own
    for res in (jres, tres):
        best = min(e["objectives"]["loss (noise free)"]
                   for e in res["evaluations"])
        assert np.isfinite(res["optimum"]) and res["optimum"] <= best + 1e-9
    assert len(tres["evaluations"]) == len(jres["evaluations"]) == EVALS
    for je, te in zip(jres["evaluations"], tres["evaluations"]):
        assert set(te) == set(je)
        assert set(te["objectives"]) == set(je["objectives"]) == {
            "loss (noisy)", "loss (noise free)"}
        noise = [e["objectives"]["loss (noisy)"]
                 - e["objectives"]["loss (noise free)"] for e in (je, te)]
        assert noise[1] == pytest.approx(noise[0], abs=1e-9)


def test_proposals_are_valid(studies):
    _, tres, _, _ = studies
    space = TBranin(**BENCH_KWARGS, seed=SEED).search_space
    for e in tres["evaluations"]:
        assert space.check_validity(e["configuration"])
        assert np.isfinite(e["objectives"]["loss (noise free)"])
        assert e["optional_info"]["model_based_pick"] is True


def test_noisy_benchmark_keeps_the_noise_free_optimum():
    clean = TBranin(n_data_per_task=[2] * 2, seed=1)
    noisy = NoisyBenchmark(clean, TNoise({"loss": 1.0}, seed=1))
    assert noisy.noise_free_benchmark is clean
    assert noisy.search_space is clean.search_space
    assert repr(noisy.noise_model) == repr(JNoise({"loss": 1.0}, seed=1))
    with pytest.raises(KeyError, match="no noise"):
        TNoise({"other": 1.0})(clean.get_meta_data("random", seed=0)[1][0])
