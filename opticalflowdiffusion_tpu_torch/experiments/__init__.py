"""Experiment runner (JAX ``experiments/``): the train loop of FlowDiffuser and FlowPred."""
