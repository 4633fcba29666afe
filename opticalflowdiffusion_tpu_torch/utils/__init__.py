"""Utilities (JAX ``utils/``): the weight bridge from flax parameters, the
checkpoints and artifact store, logging, visualisation and the Frechet
metric."""
