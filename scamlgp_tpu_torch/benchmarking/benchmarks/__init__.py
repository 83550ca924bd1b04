"""Benchmark registry of the port so far: Branin, Hartmann3D, Hartmann6D
and Quadratic (the tabular benchmarks are not ported yet)."""

from scamlgp_tpu_torch.benchmarking.benchmarks.branin import Branin
from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_3d import Hartmann3D
from scamlgp_tpu_torch.benchmarking.benchmarks.hartmann_6d import Hartmann6D
from scamlgp_tpu_torch.benchmarking.benchmarks.quadratic import Quadratic

__all__ = ["Branin", "Hartmann3D", "Hartmann6D", "Quadratic"]
