"""The estimator, its registries and its result schema."""
