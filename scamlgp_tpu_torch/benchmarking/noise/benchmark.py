"""Noisy view of a benchmark: evaluations pass through a noise model, the
ground-truth ``optimum`` stays noise-free (behavior of reference
``benchmarking/noise/benchmark.py:15-76``)."""

from __future__ import annotations

import numpy as np

from scamlgp_tpu_torch.benchmarking.benchmarks.base import Base


def _forward(attr, doc):
    """Read-only property delegating to the wrapped noise-free benchmark."""
    return property(lambda self: getattr(self._clean, attr), doc=doc)


class NoisyBenchmark(Base):
    """Wrap a benchmark so every evaluation (and every meta-data objective)
    gets a noise model applied.

    The task structure, search space, and objectives are those of the
    wrapped benchmark; regret computations keep working because the
    noise-free ``optimum`` (and ``pareto_front``, when present) is exposed
    unchanged.
    """

    def __init__(self, benchmark, noise_model):
        self._clean = benchmark
        self._noise = noise_model
        for ground_truth in ("optimum", "pareto_front"):
            if hasattr(benchmark, ground_truth):
                setattr(self, ground_truth, getattr(benchmark, ground_truth))

    @property
    def noise_free_benchmark(self):
        """The wrapped noise-free benchmark itself."""
        return self._clean

    target_task = _forward("target_task", "Target task (noise-free).")
    meta_tasks = _forward("meta_tasks", "Meta tasks (noise-free).")
    search_space = _forward("search_space", "Wrapped search space.")
    objectives = _forward("objectives", "Wrapped objective list.")
    output_dimensions = _forward("output_dimensions",
                                 "Wrapped output dimensionality.")

    @property
    def noise_model(self):
        return self._noise

    def __call__(self, eval_spec, task_uid=None):
        return self._noise(self._clean(eval_spec=eval_spec,
                                       task_uid=task_uid))

    def get_meta_data(self, distribution, seed=None):
        """Meta-data with noise drawn from ONE rng shared across all tasks
        and evaluations (so task order does not reshuffle the noise stream
        — reference ``noise/benchmark.py:55-76``)."""
        rng = np.random.default_rng(seed)
        out = {}
        for uid, evals in self._clean.get_meta_data(
                distribution=distribution, seed=rng).items():
            out[uid] = [self._noise(ev, rng) for ev in evals]
        return out
