"""The flow experiment (JAX ``experiments/matrix_flow.py``): FlowDiffuser,
FlowPred, FlowLearner, MatrixFlow or PWCLearner on the artificial, Sintel,
FlyingChairs or KITTI dataset, the counterpart of ``main.py
experiment=matrix_flow algorithm={flow_diffuser,flow_pred,flow_learner,
matrix_flow,pwc_learner} dataset={artificial,sintel,flying_chairs,
kitti_single}``.  PWCLearner also runs on the constant-velocity video
(``artificial_video``) through its three-frame view
(``data/artificial_video.py::ThreeFrameVideo``, as JAX's parity harness
feeds it).  The JAX experiment's Buck Bunny video dataset is not ported
(its video is not in the repository)."""

from __future__ import annotations

from ..algorithms.flow_diffuser import FlowDiffuser
from ..algorithms.flow_learner import FlowLearner
from ..algorithms.flow_pred import FlowPred
from ..algorithms.matrix_flow import MatrixFlow
from ..algorithms.pwc_learner import PWCLearner
from ..data.artificial_video import ThreeFrameVideo
from .base import Experiment

ALGORITHMS = {"flow_diffuser": FlowDiffuser, "flow_pred": FlowPred, "flow_learner": FlowLearner,
              "matrix_flow": MatrixFlow, "pwc_learner": PWCLearner}


class MatrixFlowExperiment(Experiment):
    """``algorithm`` names the algorithm (``ALGORITHMS``)."""

    def __init__(self, algo_cfg, train_cfg, data_cfg, out_dir, device="cuda",
                 algorithm: str = "flow_diffuser", ckpt_path=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
        self.algorithm_cls = ALGORITHMS[algorithm]
        super().__init__(algo_cfg, train_cfg, data_cfg, out_dir, device, ckpt_path)

    def dataset(self, split: str):
        """PWCLearner reads the video dataset through its three-frame view."""
        if self.algorithm.name == "pwc_learner" and self.dataset_name == "artificial_video":
            if split not in self._datasets:
                self._datasets[split] = ThreeFrameVideo(self.data_cfg, split)
            return self._datasets[split]
        return super().dataset(split)


__all__ = ["ALGORITHMS", "MatrixFlowExperiment"]
