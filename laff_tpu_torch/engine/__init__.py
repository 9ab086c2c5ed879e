"""Checkpoints, the JAX weight bridge, evaluation and prediction."""
