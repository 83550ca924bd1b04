"""Benchmark registry of this slice of the port: Branin only (the tabular
and Hartmann benchmarks are not ported yet)."""

from scamlgp_tpu_torch.benchmarking.benchmarks.branin import Branin

__all__ = ["Branin"]
