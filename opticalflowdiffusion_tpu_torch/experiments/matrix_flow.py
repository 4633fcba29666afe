"""The flow experiment (JAX ``experiments/matrix_flow.py``): FlowDiffuser,
FlowPred or FlowLearner on the artificial, Sintel, FlyingChairs or KITTI
dataset, the counterpart of ``main.py experiment=matrix_flow
algorithm={flow_diffuser,flow_pred,flow_learner}
dataset={artificial,sintel,flying_chairs,kitti_single}``.  The JAX
experiment also runs two other algorithms (MatrixFlow, PWCLearner) and the
Buck Bunny video dataset; those are not ported."""

from __future__ import annotations

from ..algorithms.flow_diffuser import FlowDiffuser
from ..algorithms.flow_learner import FlowLearner
from ..algorithms.flow_pred import FlowPred
from .base import Experiment

ALGORITHMS = {"flow_diffuser": FlowDiffuser, "flow_pred": FlowPred, "flow_learner": FlowLearner}


class MatrixFlowExperiment(Experiment):
    """``algorithm`` names the algorithm (``ALGORITHMS``)."""

    def __init__(self, algo_cfg, train_cfg, data_cfg, out_dir, device="cuda",
                 algorithm: str = "flow_diffuser", ckpt_path=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
        self.algorithm_cls = ALGORITHMS[algorithm]
        super().__init__(algo_cfg, train_cfg, data_cfg, out_dir, device, ckpt_path)


__all__ = ["ALGORITHMS", "MatrixFlowExperiment"]
