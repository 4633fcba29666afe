"""The classification experiment (JAX ``experiments/classification.py``):
the Classifier on CIFAR-10, the counterpart of ``main.py
experiment=classification algorithm=classifier dataset=cifar10``."""

from __future__ import annotations

from ..algorithms.classifier import Classifier
from ..data.cifar10 import CIFAR10Dataset
from .base import Experiment

ALGORITHMS = {"classifier": Classifier}
DATASETS = {"cifar10": CIFAR10Dataset}


class ClassificationExperiment(Experiment):
    """``algorithm`` names the algorithm (``ALGORITHMS``), the dataset config's
    ``name`` the dataset (``DATASETS``)."""

    def __init__(self, algo_cfg, train_cfg, data_cfg, out_dir, device="cuda",
                 algorithm: str = "classifier", ckpt_path=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not one of {tuple(ALGORITHMS)}")
        name = getattr(data_cfg, "name", None)
        if name not in DATASETS:
            raise ValueError(f"dataset {name!r} is not one of {tuple(DATASETS)}")
        self.algorithm_cls = ALGORITHMS[algorithm]
        super().__init__(algo_cfg, train_cfg, data_cfg, out_dir, device, ckpt_path)

    def dataset(self, split: str):
        if split not in self._datasets:
            self._datasets[split] = DATASETS[self.dataset_name](self.data_cfg, split)
        return self._datasets[split]


__all__ = ["ALGORITHMS", "ClassificationExperiment", "DATASETS"]
