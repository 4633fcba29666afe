"""Datasets (JAX ``data/``): the procedural artificial dataset."""
