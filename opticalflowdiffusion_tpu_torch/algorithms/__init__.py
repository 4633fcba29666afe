"""Algorithms (JAX ``algorithms/``): the batch adapter, FlowDiffuser, FlowPred,
FlowLearner, MatrixFlow, the animation family and PWCLearner with its loss
library."""
