"""Training utilities: meters, logs, checkpoints, environment."""
