"""Algorithms (JAX ``algorithms/``): the batch adapter and FlowDiffuser."""
