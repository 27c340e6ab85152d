"""Evaluation metrics of the port (host-side copies of the JAX package's)."""
