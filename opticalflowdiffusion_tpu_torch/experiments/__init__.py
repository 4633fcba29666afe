"""Experiment runner (JAX ``experiments/``): the train loop of the flagship."""
