"""The CIFAR-10 classifier (JAX ``algorithms/classifier.py``), NCHW.

JAX threads BatchNorm's ``batch_stats`` through the train step beside the
params, with no gradient into them; here they are the module's
``running_mean``/``running_var`` buffers (``models/resnet.py::BatchNorm``),
which a training forward folds in place outside autograd, so the train step
of ``parallel/train.py`` updates them as JAX's does.  With microbatches
(``accumulate`` > 1) the buffers fold each microbatch in turn, where JAX
averages the microbatches' folds.  The loss is the mean cross-entropy on
integer labels, with ``training/accuracy``; ``val_step`` evaluates with the
running statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ClassifierConfig
from ..models.mobilenet import MobileNetV2
from ..models.resnet import ResNet18, ResNet34
from ..models.unet import init_weights

arch_registry = dict(
    mobilenet_v2=MobileNetV2,
    resnet18=ResNet18,
    resnet34=ResNet34,
)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


class Classifier:
    """``device`` defaults to cuda; the weights are drawn from ``generator``
    (flax's initialisers: BatchNorm scale 1, bias 0, running mean 0 and
    variance 1); the module starts in eval mode (the trainer switches it)."""

    name = "classifier"

    def __init__(self, cfg: ClassifierConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if cfg.arch not in arch_registry:
            raise ValueError(f"arch {cfg.arch!r} is not one of {tuple(arch_registry)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.module = arch_registry[cfg.arch](int(cfg.num_class), int(cfg.in_channels))
        init_weights(self.module, generator if generator is not None else torch.Generator())
        self.module.to(self.device).eval()

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one training batch (images (B, C, H, W), integer
        labels (B,)); the forward runs in training mode and folds the batch
        statistics into the running ones."""
        images, labels = batch
        was = self.module.training
        self.module.train()
        try:
            logits = self.module(images)
        finally:
            self.module.train(was)
        labels = labels.long()
        loss = F.cross_entropy(logits, labels)
        return loss, {"training/accuracy": _accuracy(logits.detach(), labels)}

    @torch.no_grad()
    def val_step(self, batch, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """The loss and accuracy with the running statistics."""
        images, labels = batch
        was = self.module.training
        self.module.eval()
        try:
            logits = self.module(images)
        finally:
            self.module.train(was)
        labels = labels.long()
        return {"validation/loss": F.cross_entropy(logits, labels),
                "validation/accuracy": _accuracy(logits, labels)}, {}

    def visualize(self, batch, artifacts) -> Dict:
        return {}


__all__ = ["Classifier", "arch_registry"]
