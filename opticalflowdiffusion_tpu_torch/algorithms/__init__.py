"""Algorithms (JAX ``algorithms/``): the batch adapter, FlowDiffuser, FlowPred,
FlowLearner, MatrixFlow, the animation family, PWCLearner with its loss
library and the classifier."""
