"""The flow experiment of the flagship (JAX ``experiments/matrix_flow.py``):
FlowDiffuser on the artificial dataset, the counterpart of
``main.py experiment=matrix_flow algorithm=flow_diffuser dataset=artificial``.
The JAX experiment also runs four other algorithms on four other datasets;
those come with later slices."""

from __future__ import annotations

from ..algorithms.flow_diffuser import FlowDiffuser
from .base import Experiment


class MatrixFlowExperiment(Experiment):
    algorithm_cls = FlowDiffuser


__all__ = ["MatrixFlowExperiment"]
