"""Single-task GP, batched L-BFGS MAP fitting and the ScaML-GP model."""
