"""Benchmark registry (discoverable by introspection, as the JAX package's
``benchmarking/benchmarks/__init__.py`` and the reference's
``benchmarking/utils.py:29-43`` discovery)."""

from scamlgp_tpu_torch.benchmarking.benchmarks.branin import Branin
from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_3d import Hartmann3D
from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_6d import Hartmann6D
from scamlgp_tpu_torch.benchmarking.benchmarks.quadratic import Quadratic
from scamlgp_tpu_torch.benchmarking.benchmarks.hpo_bench_tabular import (
    HPOBenchTabular,
)
from scamlgp_tpu_torch.benchmarking.benchmarks.fcnet_fixed_fidelity_tabular import (
    FCNetFixedFidelityTabularBenchmark,
)
from scamlgp_tpu_torch.benchmarking.benchmarks.pd1 import PD1

__all__ = [
    "Branin",
    "Hartmann3D",
    "Hartmann6D",
    "Quadratic",
    "HPOBenchTabular",
    "FCNetFixedFidelityTabularBenchmark",
    "PD1",
]
