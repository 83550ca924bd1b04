"""Parameter constraints, priors and outcome standardization."""
