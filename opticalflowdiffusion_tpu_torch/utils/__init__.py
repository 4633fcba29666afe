"""Utilities (JAX ``utils/``): the weight bridge from flax parameters."""
