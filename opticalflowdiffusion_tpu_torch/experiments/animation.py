"""The video experiment (JAX ``experiments/animation.py``): FrameGenerator
or FlowCompleter on the constant-velocity video dataset or TaiChi, the counterpart of
``main.py experiment=animation algorithm={frame_generator,flow_completer}
dataset={artificial_video,taichi}``."""

from __future__ import annotations

from ..algorithms.animation import FlowCompleter, FrameGenerator
from .base import Experiment

ALGORITHMS = {"frame_generator": FrameGenerator, "flow_completer": FlowCompleter}
DATASETS = ("artificial_video", "taichi")


class AnimationExperiment(Experiment):
    """``algorithm`` names the algorithm (``ALGORITHMS``)."""

    def __init__(self, algo_cfg, train_cfg, data_cfg, out_dir, device="cuda",
                 algorithm: str = "frame_generator", ckpt_path=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
        name = getattr(data_cfg, "name", None)
        if name not in DATASETS:
            raise ValueError(f"dataset {name!r} is not one of {DATASETS}")
        self.algorithm_cls = ALGORITHMS[algorithm]
        super().__init__(algo_cfg, train_cfg, data_cfg, out_dir, device, ckpt_path)


__all__ = ["ALGORITHMS", "AnimationExperiment", "DATASETS"]
