"""Training: steps, experiment loop, checkpoints and the report."""
