"""The flow experiment (JAX ``experiments/matrix_flow.py``): FlowDiffuser or
FlowPred on the artificial dataset, the counterpart of
``main.py experiment=matrix_flow algorithm={flow_diffuser,flow_pred}
dataset=artificial``.  The JAX experiment also runs three other algorithms
(MatrixFlow, FlowLearner, PWCLearner) and four other datasets; those are not
ported."""

from __future__ import annotations

from ..algorithms.flow_diffuser import FlowDiffuser
from ..algorithms.flow_pred import FlowPred
from .base import Experiment

ALGORITHMS = {"flow_diffuser": FlowDiffuser, "flow_pred": FlowPred}


class MatrixFlowExperiment(Experiment):
    """``algorithm`` names the algorithm (``ALGORITHMS``)."""

    def __init__(self, algo_cfg, train_cfg, data_cfg, out_dir, device="cuda",
                 algorithm: str = "flow_diffuser"):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
        self.algorithm_cls = ALGORITHMS[algorithm]
        super().__init__(algo_cfg, train_cfg, data_cfg, out_dir, device)


__all__ = ["ALGORITHMS", "MatrixFlowExperiment"]
