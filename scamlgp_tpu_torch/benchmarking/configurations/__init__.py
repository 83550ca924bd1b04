"""The paper's experiment tables, one module each, as in the JAX package's
``benchmarking/configurations``: ``python -m
scamlgp_tpu_torch.benchmarking.configurations.<name> submit|visualize|hash``."""
