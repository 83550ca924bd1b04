from scamlgp_tpu_torch.benchmarking.noise.base import NoiseBase
from scamlgp_tpu_torch.benchmarking.noise.benchmark import NoisyBenchmark
from scamlgp_tpu_torch.benchmarking.noise.homoscedastic import HomoscedasticGaussianNoise

__all__ = ["NoiseBase", "NoisyBenchmark", "HomoscedasticGaussianNoise"]
